"""Build the CUDA kernels of ``cbim_tpu_torch/csrc`` and bind them.

On first use, nvcc compiles every ``csrc/*.cu`` into an object, one nvcc
process per source, all started together (the longest source sets the
build's time, so the 3^3 conv's kernels are eight sources), and
links the objects into one shared library with a plain C interface (no
PyTorch headers), under ``build/kernels/`` at the repository root (listed
in ``.gitignore``).  The file name carries a digest of the sources, the
headers and the flags, so an edited file is rebuilt and an unchanged
library is loaded as it is.  The library is loaded with ctypes; pointers
and the stream travel as ``c_void_p``.

Every entry returns ``cudaGetLastError()``; :func:`call` raises when that is
not 0.  Nothing here runs at import time: the CPU tests import every module
of the package on a machine without nvcc.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_DIR = _PKG.parent / "build" / "kernels"

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _LL, _F = (ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong,
                   ctypes.c_float)
#: argtypes of every C entry (restype int: a cudaError_t)
SIGNATURES = {
    # x, dtype, B, S, C, rows_per_chunk, n_chunks, eps, partial, mean, rstd,
    # stream
    "inorm_stats": [_P, _I, _LL, _LL, _I, _LL, _I, _F, _P, _P, _P, _P],
    # x, y, mean, rstd, dtype, act, B, S, C, stream
    "inorm_apply": [_P, _P, _P, _P, _I, _I, _LL, _LL, _I, _P],
    # x, dy, mean, rstd, dtype, act, B, S, C, rows_per_chunk, n_chunks,
    # partial, red, stream
    "inorm_bwd_stats": [_P, _P, _P, _P, _I, _I, _LL, _LL, _I, _LL, _I, _P,
                        _P, _P],
    # x, dy, dx, mean, rstd, red, dtype, act, B, S, C, stream
    "inorm_bwd_apply": [_P, _P, _P, _P, _P, _P, _I, _I, _LL, _LL, _I, _P],
    # x, w, y, dtype, B, D, H, W, C, F, stream
    "conv3d_same_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, g, partial, dw, dtype, B, D, H, W, C, F, rows_per_chunk, n_chunks,
    # stream
    "conv3d_wgrad": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, w, wpk, y, B, D, H, W, C, F, bn, flip, stream (bf16, tensor cores)
    "conv3d_same_fwd_tc": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                           _P],
    # x, w, wpk, y, B, D, H, W, C, F, bn, flip, stream (fp32, TF32 tensor
    # cores)
    "conv3d_same_fwd_tf32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                             _P],
    # x, w, wpk, y, mean, rstd, act, B, D, H, W, C, F, bn, stream (fp32,
    # TF32 tensor cores)
    "conv3d_same_na_fwd_tf32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                                _I, _I, _I, _P],
    # x, g, partial, dw, B, D, H, W, C, F, tiles_per_chunk, n_chunks, stream
    "conv3d_wgrad_tc": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # the same (fp32, TF32 tensor cores)
    "conv3d_wgrad_tf32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                          _P],
    # the same as conv3d_wgrad_na_tc (fp32, TF32 tensor cores)
    "conv3d_wgrad_na_tf32": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                             _I, _I, _I, _P],
    # x, w, wpk, y, mean, rstd, act, B, D, H, W, C, F, bn, stream (bf16,
    # tensor cores)
    "conv3d_same_na_fwd_tc": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _I, _I, _P],
    # x, g, mean, rstd, partial, dw, act, B, D, H, W, C, F, tiles_per_chunk,
    # n_chunks, stream
    "conv3d_wgrad_na_tc": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _I, _I, _I, _P],
    # x, w, y, mean, rstd, dtype, act, B, D, H, W, C, F, stream
    "conv3d_same_na_fwd": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                           _I, _P],
    # x, g, mean, rstd, partial, dw, dtype, act, B, D, H, W, C, F,
    # rows_per_chunk, n_chunks, stream
    "conv3d_wgrad_na": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                        _I, _I, _I, _P],
    # x, w, y, dtype, B, H, W, C, F, stream
    "conv2d_same_fwd": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    # x, g, partial, dw, dtype, B, H, W, C, F, rows_per_chunk, n_chunks,
    # stream
    "conv2d_wgrad": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, w, wpk, y, B, H, W, C, F, bn, flip, stream (bf16, tensor cores)
    "conv2d_same_fwd_tc": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, g, partial, dw, B, H, W, C, F, tiles_per_chunk, n_chunks, stream
    "conv2d_wgrad_tc": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # x, w, wpk, y, B, H, W, C, F, bn, flip, stream (fp32, TF32 tensor
    # cores)
    "conv2d_same_fwd_tf32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                             _P],
    # the same as conv2d_wgrad_tc (fp32, TF32 tensor cores)
    "conv2d_wgrad_tf32": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _P],
    # q, k, v, rel_bias, region, bias2, o, dtype, B, H, N, Np, D, nW,
    # split_on_load, sb, sh, sn, rsh, rsi, rsj, osb, osh, osn, stream
    "window_attention": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                         _I, _I, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL, _LL,
                         _P],
    # the probes (csrc/probes.cu, and the ladder in conv3d.cu)
    # x, y, n, vec, block, stream
    "probe_copy_scale": [_P, _P, _LL, _I, _I, _P],
    # a, w, out, T, K, N, L, slabs, stream
    "probe_dot_t": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    # a, b, out, T, M, N, K, stream
    "probe_gemm": [_P, _P, _P, _I, _I, _I, _I, _P],
    # x, w, y, dtype, B, D, H, W, C, F, phase, bn, stream
    "conv3d_same_fwd_ladder": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I,
                               _I, _P],
}

_lib = None
#: what the last build printed (ptxas register and shared-memory report)
build_log = ""
#: seconds the last build took (0.0 when the library was already built),
#: and each source's nvcc run within it (they run side by side)
build_seconds = 0.0
build_seconds_by_source: dict = {}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME") and
                 os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"),
                 shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def sources() -> list[Path]:
    srcs = sorted(CSRC.glob("*.cu"))
    if not srcs:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    return srcs


def compile_commands(obj_dir: Path, nvcc_path: str = "nvcc"
                     ) -> list[list[str]]:
    """One ``nvcc -c`` per source, each writing ``obj_dir/<stem>.o``."""
    return [[nvcc_path, *NVCC_FLAGS, "-c", "-o", str(obj_dir / f"{s.stem}.o"),
             str(s)] for s in sources()]


def link_command(out: Path, obj_dir: Path, nvcc_path: str = "nvcc"
                 ) -> list[str]:
    return [nvcc_path, "-shared", "-o", str(out),
            *(str(obj_dir / f"{s.stem}.o") for s in sources())]


def library_path() -> Path:
    """The library's path, named by a digest of the flags, the sources and
    the headers they include (``csrc/*.cuh``)."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for s in sources() + sorted(CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    return BUILD_DIR / f"libcbim_kernels_{h.hexdigest()[:16]}.so"


def build() -> Path:
    """Compile the sources unless this digest is built already; a failed
    build raises with the compiler's output."""
    global build_log, build_seconds, build_seconds_by_source
    path = library_path()
    if path.exists():
        build_seconds, build_seconds_by_source = 0.0, {}
        return path
    tmp = path.with_name(f"{path.stem}.{os.getpid()}.tmp.so")
    obj_dir = BUILD_DIR / f"{path.stem}.{os.getpid()}.obj"
    obj_dir.mkdir(parents=True, exist_ok=True)
    nvcc_path = nvcc()
    t0 = time.perf_counter()
    # each nvcc writes its log to a file, so none blocks on a full pipe
    # while the loop below waits for the others
    logs_out = [obj_dir / f"{s.stem}.log" for s in sources()]
    files = [open(log, "w") for log in logs_out]
    procs = [subprocess.Popen(cmd, stdout=f, stderr=subprocess.STDOUT)
             for cmd, f in zip(compile_commands(obj_dir, nvcc_path), files)]
    ended = {}
    while len(ended) < len(procs):
        for src, p in zip(sources(), procs):
            if src.name not in ended and p.poll() is not None:
                ended[src.name] = round(time.perf_counter() - t0, 1)
        time.sleep(0.05)
    for f in files:
        f.close()
    build_seconds_by_source = ended
    logs = [log.read_text() for log in logs_out]
    failed = [p.returncode for p in procs if p.returncode != 0]
    if not failed:
        link = subprocess.run(link_command(tmp, obj_dir, nvcc_path),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        logs.append(link.stdout)
        failed = [link.returncode] if link.returncode != 0 else []
    build_seconds = time.perf_counter() - t0
    build_log = "".join(logs)
    shutil.rmtree(obj_dir, ignore_errors=True)
    if failed:
        raise RuntimeError(f"nvcc failed ({failed}):\n{build_log}")
    os.replace(tmp, path)
    return path


def library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(str(build()))
        for name, argtypes in SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        lib.cbim_cuda_error_string.argtypes = [ctypes.c_int]
        lib.cbim_cuda_error_string.restype = ctypes.c_char_p
        _lib = lib
    return _lib


def call(name: str, *args, device) -> None:
    """Run one C entry in the context of ``device`` (a CUDA device), with
    that card's current stream as its last argument; raise if it reports a
    CUDA error."""
    import torch
    lib = library()
    with torch.cuda.device(device):
        err = getattr(lib, name)(*args, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.cbim_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
