"""Build the port's CUDA kernels at first use and bind them with ctypes.

Every source in monkeynet_tpu_torch/csrc/ is compiled for sm_90a by its own
nvcc process, all started together, and the objects are linked into one
shared library with a plain C interface. The library is keyed by a hash of
the sources and flags, so an edited kernel rebuilds and an unchanged one
loads the cached build. Nothing here runs at import: the CPU path never
needs nvcc.
"""

from __future__ import annotations

import ctypes
import fcntl
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

PACKAGE_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PACKAGE_DIR / "csrc"
BUILD_DIR = PACKAGE_DIR / "_kernels_build"
SOURCES = ("warp.cu", "warp_dsrc.cu", "warp_dgrid.cu", "combine.cu", "softargmax.cu",
           "heatmap.cu")
HEADERS = ("common.cuh",)
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# Must match enum DtypeCode in csrc/common.cuh.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_SIGNATURES = {
    "mk_warp_fwd": (_P, _P, _P, _I, _I, _I, _I, _L, _I, _I, _I, _I, _I, _L, _I, _I, _P),
    "mk_warp_dsrc": (_P, _P, _P, _I, _I, _I, _I, _L, _I, _I, _I, _I, _I, _I, _I, _I, _L, _I,
                     _I, _P),
    "mk_warp_dsrc_binned": (_P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _I, _I, _I, _I, _I, _L, _I,
                            _I, _I, _P),
    "mk_warp_dgrid": (_P, _P, _P, _P, _I, _I, _I, _I, _L, _I, _I, _I, _I, _I, _L, _I, _P),
    "mk_combine_fwd": (_P, _P, _P, _P, _L, _I, _I, _I, _P),
    "mk_softargmax_staged": (_P, _P, _L, _I, _I, _I, _F, _I, _I, _I, _P),
    "mk_softargmax_plane": (_P, _P, _L, _I, _I, _I, _F, _I, _P),
    "mk_softargmax_split": (_P, _P, _P, _L, _I, _I, _I, _F, _I, _I, _I, _I, _F, _F, _F, _F, _F,
                            _F, _P),
    "mk_heatmap_fwd": (_P, _P, _P, _L, _I, _I, _I, _F, _I, _F, _I, _I, _I, _P),
}


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError(
            "nvcc not found: the port's kernels build on a machine with the "
            "CUDA toolkit (PATH or /usr/local/cuda/bin)"
        )
    return path


def _digest() -> str:
    h = hashlib.sha256()
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC_DIR / name).read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path() -> Path:
    return BUILD_DIR / f"libmonkeynet_kernels_{_digest()}.so"


def build() -> Path:
    """Compile every source in parallel and link one .so; return its path.

    The compiler's output (ptxas register and shared-memory use per kernel)
    is kept beside the library in build.log.
    """
    lib = library_path()
    if lib.exists():
        return lib
    nvcc = _nvcc()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    # Processes of one run (the ranks of a data-parallel run) build into the
    # same directory: one builds while the others wait, then load its
    # library. The OS drops the lock with its holder, so a killed build
    # leaves none behind.
    with open(BUILD_DIR / "build.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not lib.exists():
            _compile(nvcc, lib)
    return lib


def _compile(nvcc: str, lib: Path) -> None:
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        jobs = []
        for name in SOURCES:
            obj = Path(tmp) / (Path(name).stem + ".o")
            cmd = [nvcc, *NVCC_FLAGS, "-c", str(CSRC_DIR / name), "-o", str(obj)]
            proc = subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            )
            jobs.append((name, obj, proc))
        logs, failed = [], []
        for name, _, proc in jobs:
            out, _ = proc.communicate()
            logs.append(f"== {name} (rc {proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(name)
        log = "\n".join(logs)
        (BUILD_DIR / "build.log").write_text(log)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        staged = Path(tmp) / lib.name
        link = subprocess.run(
            [nvcc, *NVCC_FLAGS[:2], "-shared", *[str(o) for _, o, _ in jobs],
             "-o", str(staged)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        if link.returncode != 0:
            raise RuntimeError(f"linking {lib.name} failed:\n{link.stdout}")
        os.replace(staged, lib)


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    return lib


def check_launch(status: int, name: str) -> None:
    """Raise if a launcher reported a CUDA error (a refused launch never
    runs, and a later synchronize would not report it)."""
    if status != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error code {status}")


def stream_of(t: torch.Tensor) -> int:
    """Handle of the current PyTorch stream on t's device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def require_cuda_tensor(t: torch.Tensor, name: str, dtypes, ndim: int) -> None:
    """The checks every wrapper makes before it hands a pointer to a kernel."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise TypeError(f"{name}: dtype {t.dtype} not in {sorted(map(str, dtypes))}")
    if t.dim() != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got shape {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")


def refuse_grad(t: torch.Tensor, name: str) -> None:
    """Raise if a forward-only kernel wrapper is handed a tensor that autograd
    is tracking: its result would carry no grad_fn and cut the graph."""
    if torch.is_grad_enabled() and t.requires_grad:
        raise RuntimeError(
            f"{name}: the kernel is forward-only and its input requires grad; "
            "call it under torch.no_grad(), or use the plain version to differentiate"
        )
