"""Tensor functions of the model, and the hand-written CUDA kernel."""
