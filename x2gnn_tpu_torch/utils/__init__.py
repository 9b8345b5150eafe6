"""Checks and interchange formats: run-to-run determinism and the
reference X2-GNN's .pth state-dict naming."""
