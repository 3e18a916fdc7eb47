"""ctypes binding of the native batch assembler (``csrc/cbim_host.cpp``),
the counterpart of ``cbim_tpu/data/native.py``.

On first use g++ builds the library into ``build/host/`` at the repository
root (listed in ``.gitignore``), named by a digest of the source and the
flags; the build writes a name of its own and renames it into place, so
processes that build at once (test workers, ranks) never load a half-written
file.  :func:`assemble_batch` copies a batch's precrop windows out of the
in-RAM volumes into the pipeline's host tensors, zero padding included, on
a persistent pool of threads capped at torch's thread count
(``torch.get_num_threads()`` when the pool is made; a forked child makes
its own).

Unlike the JAX package, which falls back to numpy when the toolchain or the
library is missing, a build or load failure raises: the 3D host-window path
runs the assembler or nothing.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import numpy as np

SOURCE = Path(__file__).resolve().parents[1] / "csrc" / "cbim_host.cpp"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "host"
CXX_FLAGS = ["-O3", "-std=c++17", "-fPIC", "-shared",
             "-pthread"]

_lib = None
#: (pid, pool): the pool of the process that made it
_pool = (None, None)


def compiler() -> str:
    cxx = os.environ.get("CXX") or shutil.which("g++")
    if not cxx:
        raise RuntimeError("the batch assembler needs a C++ compiler: no "
                           "g++ on PATH (set CXX)")
    return cxx


def library_path() -> Path:
    """The library's path, named by a digest of the flags and the source."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    h.update(SOURCE.read_bytes())
    return BUILD_DIR / f"libcbim_host_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the source unless this digest is built already; a failed
    build raises with the compiler's output."""
    path = library_path()
    if path.exists():
        return path
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    cmd = [compiler(), *CXX_FLAGS, "-o", str(tmp), str(SOURCE)]
    try:
        r = subprocess.run(cmd, stdout=subprocess.PIPE,
                           stderr=subprocess.STDOUT, text=True)
    except OSError as e:
        raise RuntimeError(f"building {SOURCE.name} failed: {e}") from e
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"building {SOURCE.name} failed "
                           f"({r.returncode}):\n{r.stdout}")
    os.replace(tmp, path)
    return path


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        lib.cbim_pool_create.restype = ctypes.c_void_p
        lib.cbim_pool_create.argtypes = [ctypes.c_int]
        lib.cbim_pool_destroy.argtypes = [ctypes.c_void_p]
        lib.cbim_assemble_batch.restype = ctypes.c_int
        lib.cbim_assemble_batch.argtypes = [
            ctypes.c_void_p, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
            ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, ctypes.c_void_p,
            ctypes.c_void_p]
        _lib = lib
    return _lib


def pool() -> int:
    """This process's thread pool, made on first use with torch's thread
    count."""
    global _pool
    if _pool[0] != os.getpid():
        import torch
        _pool = (os.getpid(),
                 library().cbim_pool_create(torch.get_num_threads()))
    return _pool[1]


def _addresses(arrays) -> ctypes.Array:
    return (ctypes.c_void_p * len(arrays))(*(a.ctypes.data for a in arrays))


def assemble_batch(images, labels, windows: np.ndarray, out_img: np.ndarray,
                   out_lab: np.ndarray) -> None:
    """Copy each sample's window into ``out_img`` (B, bd, bh, bw) float32
    and ``out_lab`` (B, bd, bh, bw) int8, zeros around it.

    images/labels: B C-contiguous (D, H, W) float32 / int8 volumes;
    windows: (B, 9) int [z0, y0, x0, wz, wy, wx, oz, oy, ox] per sample:
    the source start, the copied extent and its offset in the buffer."""
    B = len(images)
    if len(labels) != B or windows.shape != (B, 9):
        raise ValueError(f"{B} images, {len(labels)} labels and windows of "
                         f"shape {windows.shape}")
    for arrs, dtype in ((images, np.float32), (labels, np.int8)):
        for a in arrs:
            if a.dtype != dtype or a.ndim != 3 or not a.flags.c_contiguous:
                raise ValueError(f"expected C-contiguous (D, H, W) "
                                 f"{dtype.__name__} volumes, got "
                                 f"{a.dtype}{a.shape}")
    for out, dtype in ((out_img, np.float32), (out_lab, np.int8)):
        if (out.dtype != dtype or out.ndim != 4 or out.shape[0] != B
                or not out.flags.c_contiguous):
            raise ValueError(f"expected a C-contiguous (B, bd, bh, bw) "
                             f"{dtype.__name__} buffer, got "
                             f"{out.dtype}{out.shape}")
    if out_lab.shape != out_img.shape:
        raise ValueError(f"buffers {out_img.shape} and {out_lab.shape}")
    dims = np.array([a.shape for a in images], np.int64).reshape(B, 3)
    win = np.ascontiguousarray(windows, np.int64)
    bd, bh, bw = out_img.shape[1:]
    rc = library().cbim_assemble_batch(
        pool(), B, _addresses(images), _addresses(labels), dims.ctypes.data,
        win.ctypes.data, bd, bh, bw, out_img.ctypes.data, out_lab.ctypes.data)
    if rc != 0:
        raise RuntimeError(f"cbim_assemble_batch failed rc={rc}")
