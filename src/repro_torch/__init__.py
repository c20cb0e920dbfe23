"""HPTMT on PyTorch: the port of the JAX package ``repro`` to PyTorch and
hand-written CUDA kernels for an NVIDIA H100 (Hopper).

Same layout module for module: ``repro_torch/core/exchange.py`` ports
``repro/core/exchange.py``.  This package imports ``torch`` and numpy,
never JAX or the JAX package.
"""
