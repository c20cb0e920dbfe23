"""Masked online-softmax attention (flash attention) of the serving path."""
