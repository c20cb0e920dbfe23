"""Build and load the hand-written CUDA kernels (``src/repro_torch/csrc``).

Every ``csrc/*.cu`` compiles with ``nvcc`` for Hopper (``sm_90a``) into an
object file — one ``nvcc`` process per source, all started together — and
the objects link into one shared library with a plain C interface, loaded
with ``ctypes``.  The build happens at first use and is keyed by a hash
of the sources and flags, so a fresh checkout builds once and later calls
reuse the library.  Nothing here runs at import time: this module imports
on machines with no CUDA toolkit, where no kernel is ever launched.

Conventions of the C entry points: every pointer and the stream are
``c_void_p``, sizes are ``c_int64``, small integers ``c_int``, scales
``c_float``, and each returns ``cudaGetLastError()`` so the wrapper can
raise on a refused launch.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
import time
from pathlib import Path
from typing import Optional

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parent.parent / "build"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
FLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-lineinfo"]

P = ctypes.c_void_p
I64 = ctypes.c_int64
INT = ctypes.c_int
F32 = ctypes.c_float

#: argtypes of every C entry point (each returns ``cudaError_t`` as int)
SIGNATURES = {
    # keys, n, k, valid, n_parts, dest, hist, h1, h2, stream
    "hptmt_hash_partition": [P, I64, INT, P, INT, P, P, P, P, P],
    # records, side, slots, lanes, ph1, ph2, pkeys, pvalid, n,
    # max_matches, max_probes, cnt, rimat, exhausted, stream
    "hptmt_probe": [P, P, I64, INT, P, P, P, P, I64, INT, INT, P, P, P, P],
    # values, seg, n, lanes, num_segments, out, stream
    "hptmt_segment_sum_fused": [P, P, I64, INT, I64, P, P],
    # values, seg, n, num_segments, op (0 sum, 1 min, 2 max), out, stream
    "hptmt_segment_reduce": [P, P, I64, I64, INT, P, P],
    # num_segments, lanes → 1 for the shared-memory path, 0 for direct
    "hptmt_segment_privatized": [I64, INT],
    # values, row stride, seg, n, lanes, window, op (0 sum, 1 min, 2 max),
    # tile, pre, suf, carry_pre, carry_suf, out, stream
    "hptmt_windowed_scan": [P, I64, P, I64, INT, I64, INT, INT, P, P, P, P,
                            P, P],
    # q, k, v, o, batch, hq, hkv, sq, sk, d, the (batch, head, seq)
    # strides of q, k, v and o, causal, window (-1: none), kv_len,
    # q_offset, sm_scale, stream: float32 on the FMA units ...
    "hptmt_flash_attention": [P, P, P, P, I64, I64, I64, I64, I64, INT,
                              *[I64] * 12, INT, I64, I64, I64, F32, P],
    # ... and bfloat16 on the tensor cores (the same arguments)
    "hptmt_flash_attention_sm90": [P, P, P, P, I64, I64, I64, I64, I64, INT,
                                   *[I64] * 12, INT, I64, I64, I64, F32, P],
}

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None
#: seconds the last build took (0.0 when the library was already built)
build_seconds = 0.0


def cuda_tool(name: str = "nvcc") -> str:
    """Path of a CUDA toolkit program (``nvcc``, ``cuobjdump``)."""
    found = shutil.which(name)
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    cand = Path(home) / "bin" / name
    if cand.exists():
        return str(cand)
    raise RuntimeError(f"{name} not found: the CUDA kernels cannot be "
                       "built (set CUDA_HOME or put nvcc on PATH)")


def _sources(csrc: Path):
    return sorted(csrc.glob("*.cu"))


def _digest(csrc: Path) -> str:
    h = hashlib.sha256(" ".join(ARCH + FLAGS).encode())
    for path in sorted(csrc.iterdir()):
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _run(procs, verbose: bool) -> None:
    for src, proc in procs:
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src.name}:\n{out}")
        if verbose and out:
            print(f"[nvcc {src.name}]\n{out}", flush=True)


def build(verbose: bool = False, csrc: Path = CSRC,
          out: Path = BUILD) -> Path:
    """Compile the kernels of ``csrc`` into ``out`` if the library for
    these sources is missing.

    ``verbose`` prints what ``ptxas -v`` reports for each kernel
    (registers, shared memory, spills).
    """
    global build_seconds
    lib = out / f"libhptmt_{_digest(csrc)}.so"
    if lib.exists():
        build_seconds = 0.0
        return lib
    t0 = time.perf_counter()
    out.mkdir(parents=True, exist_ok=True)
    nvcc = cuda_tool()
    with tempfile.TemporaryDirectory(dir=out) as tmp:
        extra = ["-Xptxas", "-v"] if verbose else []
        procs = []
        for src in _sources(csrc):
            obj = Path(tmp) / (src.stem + ".o")
            cmd = [nvcc, *ARCH, *FLAGS, *extra, "-I", str(csrc), "-c",
                   str(src), "-o", str(obj)]
            procs.append((src, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        _run(procs, verbose)
        objs = [str(Path(tmp) / (s.stem + ".o")) for s in _sources(csrc)]
        part = Path(tmp) / lib.name
        link = subprocess.Popen([nvcc, *ARCH, "-shared", "-o", str(part),
                                 *objs], stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        _run([(part, link)], verbose)
        os.replace(part, lib)  # atomic: a concurrent build never sees half
    build_seconds = time.perf_counter() - t0
    return lib


def load(path: Path) -> ctypes.CDLL:
    """Open a built library and bind the argtypes of its entry points."""
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.hptmt_error_string.argtypes = [ctypes.c_int]
    lib.hptmt_error_string.restype = ctypes.c_char_p
    return lib


def library(verbose: bool = False) -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            _LIB = load(build(verbose))
        return _LIB


def check(name: str, err: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        msg = library().hptmt_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")


def on_cuda(t: torch.Tensor) -> bool:
    """Dispatch rule of every ``ops.py``: True for a CUDA tensor (launch
    the kernel), False for a CPU tensor (the plain version); any other
    device raises — nothing falls back from one to the other."""
    if t.device.type == "cuda":
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"no kernel or plain version for device {t.device}")


def stream(device: torch.device) -> int:
    """PyTorch's current stream on ``device``, as the raw handle.

    The C entry points launch on the CURRENT CUDA device, whatever device
    the stream belongs to, so a tensor on another card raises here,
    before the launch, instead of handing a kernel that card's pointers
    (a rank that never called ``torch.cuda.set_device`` would launch on
    card 0)."""
    current = torch.cuda.current_device()
    index = current if device.index is None else device.index
    if index != current:
        raise RuntimeError(
            f"kernel inputs are on cuda:{index} but the current CUDA device "
            f"is cuda:{current}: call torch.cuda.set_device({index}) first")
    return torch.cuda.current_stream(device).cuda_stream


def ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def require(t: torch.Tensor, name: str, dtype: torch.dtype,
            device: torch.device) -> torch.Tensor:
    """Validate one kernel argument: CUDA, dtype, device; contiguous copy."""
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name} has dtype {t.dtype}, expected {dtype}")
    return t.contiguous()
