"""Build and load the port's CUDA kernels (``csrc/*.cu``).

The sources are compiled with ``nvcc`` for Hopper (``sm_90a``), one
``nvcc`` per source, all started together, and linked into one shared
library with a plain C interface, loaded with ``ctypes``.  The build runs at
first use, into ``fluidsim_tpu_torch/_build/`` (listed in ``.gitignore``),
under a name keyed by a hash of the sources and flags, so a fresh checkout
builds once and an edited source rebuilds.  Nothing here runs at import
time: the CPU tests import every module without a CUDA toolkit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG / "_build"
SOURCES = ("transfer.cu", "stencil.cu", "bucket.cu", "layout.cu", "rows.cu",
           "mat3.cu")
HEADERS = ("tile_search.cuh",)      # included by the sources: in the hash too
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "--fmad=false", "-Xcompiler", "-fPIC", "-Xptxas", "-v")
LINK_FLAGS = ("-shared",)

_P = ctypes.c_void_p
_LL = ctypes.c_longlong
_SIGNATURES = {
    # name: argtypes (pointers and the stream as void*, sizes as int64)
    # the K1 modes, the K2 gathers and K3/K4 take the grid's x extent nx
    # before n: an (nx, n, n) slab, or the cube with nx = n
    "fs_p2g_scatter": (_P, _P, _P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, ctypes.c_int, _P),
    "fs_p2g_scatter_affine": (_P, _P, _P, _P, _P, _P, _P, _P, ctypes.c_int,
                              ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                              _P),
    "fs_p2g_scatter_force": (_P, _P, _P, _P, _P, _P, _P, ctypes.c_int,
                             ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
                             _P),
    "fs_chunk_fill": (_P, _P, _P, _P, ctypes.c_int, ctypes.c_int, _P),
    # the gathers: src, weights, ids, live count (or None), out, nx, n, P
    # (K2 and K2 moments then their tile-path counts, or None)
    "fs_g2p_gather": (_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                      ctypes.c_longlong, _P, _P),
    "fs_g2p_moments": (_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                       ctypes.c_longlong, _P, _P),
    "fs_g2p_gather_gw": (_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                         ctypes.c_longlong, _P),
    "fs_g2p_gather_table": (_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                            ctypes.c_longlong, _P),
    "fs_g2p_moments_table": (_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_int,
                             ctypes.c_longlong, _P),
    "fs_p2g_scatter_base": (_P, _P, _P, _P, _P, _P, _P, ctypes.c_int,
                            ctypes.c_longlong, _P),
    "fs_p2g_scatter_spans": (_P, _P, _P, _P, _P, _P, _P, ctypes.c_int,
                             ctypes.c_longlong, _P),
    "fs_g2p_gather_spans": (_P, _P, _P, _P, _P, ctypes.c_int,
                            ctypes.c_longlong, ctypes.c_int, _P),
    "fs_shift_reduce": (_P, _P, ctypes.c_int, _P),
    "fs_shift_expand": (_P, _P, ctypes.c_int, _P),
    "fs_shift_reduce_rows": (_P, _P, ctypes.c_int, _P),
    "fs_shift_expand_rows": (_P, _P, ctypes.c_int, _P),
    "fs_transpose_pad": (_P, _P, ctypes.c_longlong, ctypes.c_longlong,
                         ctypes.c_longlong, ctypes.c_longlong, _P),
    "fs_gather_rows_cm": (_P, _P, _P, _P, ctypes.c_longlong, ctypes.c_longlong,
                          ctypes.c_longlong, _P),
    "fs_scatter_rows_cm": (_P, _P, _P, _P, ctypes.c_longlong,
                           ctypes.c_longlong, _P),
    "fs_bucket_move": (_P, _P, _P, _P, _P, ctypes.c_int, ctypes.c_longlong,
                       ctypes.c_longlong, ctypes.c_int, ctypes.c_int,
                       ctypes.c_int, _P),
    # K3: p, adiag, their four edge planes (or null), out, scale, nx, n,
    # stream
    "fs_apply_laplacian": (_P, _P, _P, _P, _P, _P, _P, ctypes.c_float,
                           ctypes.c_int, ctypes.c_int, _P),
    # K4: the 12 field pointers, zn, dn, the host (c1, c2) pairs, steps,
    # scale, 1/theta, nx, n, stream
    "fs_cheb_steps": (_P, _P, _P, _P, ctypes.c_int, ctypes.c_float,
                      ctypes.c_float, ctypes.c_int, ctypes.c_int, _P),
    # the MPM 3x3 chain (mat3.cu): a (P, 3, 3) operand as its pointer and
    # three element strides; outputs, then P and the stream
    "fs_polar_stress": (_P, _LL, _LL, _LL, _P, _P, _P, _P, _LL, _P),
    "fs_stress_apply": (_P, _P, _LL, _LL, _LL, _P, _P, _P, _P, _P,
                        ctypes.c_int, _LL, _P),
    "fs_clamp_singular": (_P, _LL, _LL, _LL, ctypes.c_float, ctypes.c_float,
                          _P, _P, _LL, _P),
    "fs_mm3": (_P, _LL, _LL, _LL, _P, _LL, _LL, _LL, _P, _LL, _P),
}

_lib: ctypes.CDLL | None = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") \
        or "/usr/local/cuda"
    path = os.path.join(home, "bin", "nvcc")
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA "
                           "toolkit (set CUDA_HOME or put nvcc on PATH)")
    return path


def library_path() -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + LINK_FLAGS).encode())
    for name in SOURCES + HEADERS:
        h.update(name.encode())
        h.update((CSRC / name).read_bytes())
    return BUILD_DIR / f"libfluidsim_kernels_{h.hexdigest()[:16]}.so"


def build_log() -> str:
    """nvcc's output of the build of this library (ptxas's register and
    spill report of every kernel), kept beside it; "" before a build."""
    log = library_path().with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build() -> Path:
    """Compile the kernels if no library for these sources exists yet;
    return its path.  Each source compiles in its own ``nvcc`` process, all
    at once; the objects are linked under a temporary name and renamed into
    place, so concurrent builders never load a partial file.  nvcc's output
    is written beside the library first (``build_log``)."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [os.path.join(tmp, Path(s).stem + ".o") for s in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", str(CSRC / s),
                                   "-o", o], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for s, o in zip(SOURCES, objs)]
        log = "".join(p.communicate()[0] for p in procs)
        failed = [s for s, p in zip(SOURCES, procs) if p.returncode != 0]
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n{log}")
        lib = os.path.join(tmp, out.name)
        res = subprocess.run([nvcc, *LINK_FLAGS, "-o", lib, *objs],
                             capture_output=True, text=True)
        log += res.stdout + res.stderr
        if res.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({res.returncode}):\n"
                               f"{log}")
        log_tmp = Path(tmp) / "build.log"
        log_tmp.write_text(log)
        os.replace(log_tmp, out.with_suffix(".log"))
        os.replace(lib, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded kernel library (built on first use)."""
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = list(argtypes)
            fn.restype = ctypes.c_int
        _lib = lib
    return _lib


def require_cuda(t: torch.Tensor, name: str):
    """Raise unless ``t`` lies on a CUDA device: a kernel wrapper takes its
    plain version for CPU tensors only, and has nothing for other devices."""
    if t.device.type != "cuda":
        raise ValueError(f"{name}: no kernel for device {t.device} "
                         "(CPU tensors take the plain version, others none)")


def check_tensor(name: str, t: torch.Tensor, dtype, shape, device):
    """Raise unless ``t`` is a contiguous tensor of ``dtype`` and ``shape``
    on ``device`` — what the kernels take."""
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, "
                         f"expected {tuple(shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")


def check_launch(name: str, rc: int):
    """Raise if a kernel launch returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {rc}")


def stream_ptr(device) -> int:
    """The current PyTorch CUDA stream of ``device`` as an integer handle."""
    return torch.cuda.current_stream(device).cuda_stream
