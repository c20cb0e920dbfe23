"""Hand-written CUDA kernels for the HPTMT hot spots (Hopper, ``sm_90a``).

Each kernel package keeps the reference's split: ``ref.py`` (the plain
PyTorch version, run for CPU tensors and used as the oracle on the card),
``kernel.py`` (the ctypes wrapper around the CUDA source in ``csrc/``,
with its launch counter) and ``ops.py`` (the dispatcher: a CUDA tensor
goes to the kernel, a CPU tensor to the plain version; there is no
fallback between the two).
"""
