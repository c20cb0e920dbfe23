"""Tensor-side models of the port: the dense decoder-only serving path."""
