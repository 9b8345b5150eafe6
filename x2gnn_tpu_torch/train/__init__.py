"""Training: losses, optimizer, EMA, checkpoints and the Trainer
(x2gnn_tpu/train). `python -m x2gnn_tpu_torch.train` is the CLI."""
