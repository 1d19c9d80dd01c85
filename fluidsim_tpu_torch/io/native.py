"""ctypes bindings for the native VDB encoder and async writer queue
(``csrc/vdbio.cc``) — the counterpart of ``fluidsim_tpu/io/native.py``.

The queue is the analogue of ``openvdb::io::Queue``
(``openvdb/io/Queue.h:248``): frame exports are handed to a background
thread so the frame loop never stalls on encoding or disk.

The library is host code, not a kernel: it is built at first use with the
host C++ compiler (``$CXX``, else ``g++``) into ``fluidsim_tpu_torch/_build/``
under a name keyed by a hash of the source and flags, linked under a
temporary name and renamed into place, so concurrent builds (test
workers) never load a partial file.  When the build fails, ``AsyncVdbWriter``
writes its frames with the Python writer, counts them in
``python_fallbacks`` and says so once on stderr with the compiler's first
error line; ``encode_native`` raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import sys
import tempfile
import uuid as _uuid
from pathlib import Path

import numpy as np

_PKG = Path(__file__).resolve().parents[1]
SOURCE = _PKG / "csrc" / "vdbio.cc"
BUILD_DIR = _PKG / "_build"
CXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")
LIBS = ("-lz", "-lpthread")

_lib = None
_build_error: "BuildError | None" = None


class BuildError(RuntimeError):
    """The native writer did not build; ``first_line`` is the compiler's
    first error line."""

    def __init__(self, first_line: str, log: str):
        super().__init__(f"{first_line}\n{log}")
        self.first_line = first_line


def _compiler() -> str:
    return os.environ.get("CXX") or "g++"


def library_path() -> Path:
    h = hashlib.sha256(" ".join(CXX_FLAGS + LIBS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libvdbio_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile ``csrc/vdbio.cc`` unless a library of this source and these
    flags exists; return its path.  Raises ``BuildError``."""
    out = library_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        lib = os.path.join(tmp, out.name)
        cmd = [_compiler(), *CXX_FLAGS, "-o", lib, str(SOURCE), *LIBS]
        try:
            res = subprocess.run(cmd, capture_output=True, text=True)
        except OSError as e:
            raise BuildError(f"{cmd[0]}: {e}", "") from e
        if res.returncode != 0:
            log = res.stdout + res.stderr
            errors = [ln for ln in log.splitlines() if "error" in ln]
            first = (errors or log.splitlines() or
                     [f"{cmd[0]} exited with {res.returncode}"])[0]
            raise BuildError(first.strip(), log)
        os.replace(lib, out)
    return out


def library() -> ctypes.CDLL:
    """The loaded writer library (built on first use).  A failed build is
    remembered and raised again, not retried."""
    global _lib, _build_error
    if _lib is not None:
        return _lib
    if _build_error is not None:
        raise _build_error
    try:
        lib = ctypes.CDLL(str(build()))
    except BuildError as e:
        _build_error = e
        raise
    except OSError as e:
        _build_error = BuildError(f"loading the writer library: {e}", "")
        raise _build_error from e
    lib.vdbio_encode.restype = ctypes.c_long
    lib.vdbio_encode.argtypes = [
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_double, ctypes.c_char_p, ctypes.c_uint32,
        ctypes.c_char_p, ctypes.POINTER(ctypes.POINTER(ctypes.c_uint8))]
    lib.vdbio_free.restype = None
    lib.vdbio_free.argtypes = [ctypes.POINTER(ctypes.c_uint8)]
    lib.vdbio_queue_create.restype = ctypes.c_void_p
    lib.vdbio_queue_create.argtypes = []
    lib.vdbio_queue_submit.restype = None
    lib.vdbio_queue_submit.argtypes = [
        ctypes.c_void_p, ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_uint8),
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_float, ctypes.c_double, ctypes.c_char_p, ctypes.c_uint32,
        ctypes.c_char_p]
    lib.vdbio_queue_pending.restype = ctypes.c_long
    lib.vdbio_queue_pending.argtypes = [ctypes.c_void_p]
    lib.vdbio_queue_flush.restype = None
    lib.vdbio_queue_flush.argtypes = [ctypes.c_void_p]
    lib.vdbio_queue_destroy.restype = None
    lib.vdbio_queue_destroy.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def available() -> bool:
    try:
        library()
    except BuildError:
        return False
    return True


def _grid_args(grid, compression, uuid36):
    vals = np.ascontiguousarray(grid.values, np.float32)
    if vals.ndim != 3:
        raise ValueError(f"native writer takes 3-d float grids, got shape "
                         f"{vals.shape}")
    act = grid.active
    act = (np.ascontiguousarray(act, np.uint8) if act is not None
           else np.ones(vals.shape, np.uint8))
    if act.shape != vals.shape:
        raise ValueError(f"active mask {act.shape} != values {vals.shape}")
    return (vals.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
            act.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
            vals.shape[0], vals.shape[1], vals.shape[2],
            int(grid.origin[0]), int(grid.origin[1]), int(grid.origin[2]),
            float(grid.background), float(grid.voxel_size),
            grid.name.encode(), compression, uuid36.encode(), vals, act)


def encode_native(grid, compression: int, uuid36: str | None = None) -> bytes:
    """Encode one grid into a single-grid archive, natively (raises
    ``BuildError`` when the library did not build)."""
    lib = library()
    uuid36 = uuid36 or str(_uuid.uuid4())
    *args, vals, act = _grid_args(grid, compression, uuid36)
    out = ctypes.POINTER(ctypes.c_uint8)()
    n = lib.vdbio_encode(*args, ctypes.byref(out))
    data = ctypes.string_at(out, n)
    lib.vdbio_free(out)
    return data


class AsyncVdbWriter:
    """Background frame writer (a native thread; the ``io::Queue``
    analogue).  Writes synchronously with the Python writer only when the
    native library failed to build: ``python_fallbacks`` counts those
    frames, and the first failure prints one line to stderr."""

    def __init__(self, compression: int | None = None):
        from fluidsim_tpu_torch.io.vdb import (COMPRESS_ACTIVE_MASK,
                                               COMPRESS_ZIP)
        self.compression = (COMPRESS_ZIP | COMPRESS_ACTIVE_MASK
                            if compression is None else compression)
        self.python_fallbacks = 0
        try:
            self._lib = library()
        except BuildError as e:
            self._lib = None
            print(f"vdbio: the native writer did not build, writing frames "
                  f"with the Python writer: {e.first_line}", file=sys.stderr)
        self._q = self._lib.vdbio_queue_create() if self._lib else None

    def submit(self, path: str, grid):
        if self._lib is None:
            from fluidsim_tpu_torch.io.vdb import write_vdb
            write_vdb(path, [grid], compression=self.compression)
            self.python_fallbacks += 1
            return
        if self._q is None:
            raise RuntimeError("AsyncVdbWriter is closed")
        *args, vals, act = _grid_args(grid, self.compression,
                                      str(_uuid.uuid4()))
        # vals and act stay referenced here until the call returns: the
        # native submit copies them into its job before returning
        self._lib.vdbio_queue_submit(self._q, path.encode(), *args)

    def pending(self) -> int:
        return int(self._lib.vdbio_queue_pending(self._q)) if self._q else 0

    def flush(self):
        if self._q is not None:
            self._lib.vdbio_queue_flush(self._q)

    def close(self):
        if self._q is not None:
            self.flush()
            self._lib.vdbio_queue_destroy(self._q)
            self._q = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
