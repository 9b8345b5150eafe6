"""nn.Modules of the model."""
