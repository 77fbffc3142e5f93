"""Build and bind the hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` for ``sm_90a`` into a shared
library with a plain C interface, loaded with ``ctypes`` — no PyTorch
headers, so a build takes seconds.  Libraries land in
``build/repro_torch/`` at the repository root, named by a hash of the
sources and flags, so an edit rebuilds and an unchanged checkout
reuses.  Nothing is built when this module is imported: the first
launch builds what it needs (``build_all`` builds every source at once,
one ``nvcc`` each, in parallel).
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path
from typing import Dict, Sequence

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")
SOURCES = ("paged_decode.cu", "paged_prefill.cu", "flash_prefill.cu",
           "ssd_scan.cu", "paged_decode_int8.cu", "moe_grouped.cu")

_CTYPES = {"p": ctypes.c_void_p, "i": ctypes.c_int, "l": ctypes.c_longlong,
           "f": ctypes.c_float}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels are built at first "
                       "use and need the CUDA toolkit (nvcc on PATH or "
                       "under /usr/local/cuda)")


def library_path(source: str) -> Path:
    """Where ``source``'s library lives: keyed by the source, every
    header it may include, and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in [CSRC / source] + sorted(CSRC.glob("*.cuh")):
        h.update(p.read_bytes())
    return BUILD_DIR / f"{Path(source).stem}-{h.hexdigest()[:16]}.so"


def build_all(sources: Sequence[str] = SOURCES) -> Dict[str, float]:
    """Compile every library of ``sources`` that is not built yet, one
    ``nvcc`` per source, all started together.  Returns the seconds
    each compile took (absent = already built).  Raises with the
    compiler's output when one fails."""
    todo = [s for s in sources if not library_path(s).exists()]
    if not todo:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for s in todo:
        out = library_path(s)
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / s)]
        procs[s] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                     stderr=subprocess.STDOUT, text=True),
                    tmp, out, time.perf_counter())
    took: Dict[str, float] = {}
    failed = []
    for s, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        took[s] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"nvcc {s} exited {proc.returncode}:\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)
    if failed:
        raise RuntimeError("\n".join(failed))
    return took


@functools.lru_cache(maxsize=None)
def library(source: str) -> ctypes.CDLL:
    """The loaded library of ``source``, built first if needed."""
    build_all([source])
    return ctypes.CDLL(str(library_path(source)))


class CudaKernel:
    """One C entry point of a kernel library, with its launch count.

    ``signature`` spells the argument types before the trailing stream
    (``p`` pointer, ``i`` int, ``l`` 64-bit int, ``f`` float).  Calling launches on the
    current stream of ``device``, raises if the launch was refused
    (the C function returns ``cudaGetLastError()``), and counts one
    launch — the only place a kernel's count moves."""

    def __init__(self, symbol: str, source: str, signature: str,
                 replaces: str):
        self.symbol = symbol
        self.source = source
        self.signature = signature
        self.replaces = replaces
        self.launches = 0
        self._fn = None
        self._err_str = None

    def _bind(self):
        lib = library(self.source)
        fn = getattr(lib, self.symbol)
        fn.argtypes = [_CTYPES[c] for c in self.signature] + [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        err_str = lib.repro_error_string
        err_str.argtypes = [ctypes.c_int]
        err_str.restype = ctypes.c_char_p
        self._err_str = err_str
        self._fn = fn
        return fn

    def __call__(self, *args, device: torch.device) -> None:
        fn = self._fn or self._bind()
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = fn(*args, stream)
        if err != 0:
            raise RuntimeError(f"{self.symbol} launch failed: CUDA error "
                               f"{err} ({self._err_str(err).decode()})")
        self.launches += 1


@functools.lru_cache(maxsize=None)
def sm_count(device: torch.device) -> int:
    """The SM count of CUDA ``device`` (a tensor's: it has an index),
    read once per device; the kernels' grids are planned from it."""
    return torch.cuda.get_device_properties(device).multi_processor_count


def dtype_code(dtype: torch.dtype) -> int:
    """The kernels' element-type code (0 f32, 1 bf16)."""
    codes = {torch.float32: 0, torch.bfloat16: 1}
    if dtype not in codes:
        raise TypeError(f"the CUDA kernels take float32 or bfloat16, "
                        f"not {dtype}")
    return codes[dtype]


def check_operands(name: str, device: torch.device, align: int = 16,
                   **tensors) -> None:
    """Raise unless every tensor lies on ``device``, is contiguous and
    ``align``-byte aligned (16 for the kernels' vector loads)."""
    for key, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name}: {key} is on {t.device}, expected "
                             f"{device}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: {key} must be contiguous")
        if t.data_ptr() % align:
            raise ValueError(f"{name}: {key} must be {align}-byte aligned")
