"""Serving engine of the port: batched prefill and lockstep decode."""
