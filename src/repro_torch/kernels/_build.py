"""Build and load the port's CUDA kernels (plain-C shared libraries).

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into
``build/lib<name>-<hash>.so`` at the repository root, where ``<hash>`` is
taken from the source, the shared ``csrc/*.cuh`` headers and the flags, so
a changed source is never served by a stale library. Nothing is built at import time: the first wrapper
call that launches a kernel builds its library (or :func:`build_all` builds
every library in parallel), and the library is then loaded with
``ctypes``.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build"
KERNELS = ("flash_attention", "flash_attention_bwd", "paged_attention", "ssd_scan",
           "ssd_scan_bwd", "sim_decode")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float
_D = ctypes.c_double

#: ctypes signatures of the exported C entry points.
SIGNATURES = {
    "flash_attention": (
        "flash_attention_fwd",
        # q, k, v, o, lse (null: none), B, H, KH, Lq, Lk, D, causal, scale,
        # dtype, element strides (b, h, l) of q, k, v and o, stream
        [_P] * 5 + [_I, _I, _I, _I, _I, _I, _I, _F, _I] + [_L] * 12 + [_P],
    ),
    "flash_attention_bwd": (
        "flash_attention_bwd",
        # q, k, v, o, dO, lse, delta (scratch), dq, dk, dv, B, H, KH, Lq, Lk,
        # D, causal, scale, dtype, host array of 24 element strides, the
        # dkdv work list (device int32, null for the CUDA-core variant),
        # its items, the split, stream
        [_P] * 10 + [_I] * 7 + [_F, _I, _P, _P, _I, _I, _P],
    ),
    "paged_attention": (
        "paged_attention_fwd",
        # q, k_pages, v_pages, k_scales, v_scales, block_tables, lengths, o,
        # lse (null: none), B, H, KH, D, page, pps, splits, scale, q_dtype,
        # kv_dtype, scale_dtype, stream
        [_P] * 9 + [_I] * 7 + [_F, _I, _I, _I, _P],
    ),
    "ssd_scan": (
        "ssd_scan_fwd",
        # x, log_a, b, c, y, s_out, s_chunks (null: none), B, H, L, P, N,
        # x_dtype, bc_dtype, stream
        [_P] * 7 + [_I] * 7 + [_P],
    ),
    "ssd_scan_bwd": (
        "ssd_scan_bwd",
        # x, log_a, b, c, dy, ds_final (null: zero), states, ds (scratch),
        # dx, dlog_a, db_parts, dc_parts (scratch), db, dc, B, H, L, P, N,
        # bc_dtype, variant (0 tensor cores, 1 CUDA cores), group, stream
        [_P] * 14 + [_I] * 8 + [_P],
    ),
    "sim_decode": (
        "sim_decode_advance",
        # t_limit, busy, now, nact, free, occ, pre, sq, inp, gen, rem, blk,
        # ft, tr, c_max; outputs pre, dec, k, end, gen, rem, ft, trunc_new,
        # tr, comp; G, P, I, S, w, h, chunk, stream
        [_P] * 25 + [_I, _I, _I, _I, _D, _D, _I, _P],
    ),
}


def find_nvcc() -> str:
    """Path of ``nvcc``: ``$CUDA_HOME/bin``, then ``PATH``, then the
    toolkit's default prefix. Raises when there is none."""
    candidates = []
    if os.environ.get("CUDA_HOME"):
        candidates.append(os.path.join(os.environ["CUDA_HOME"], "bin", "nvcc"))
    on_path = shutil.which("nvcc")
    if on_path:
        candidates.append(on_path)
    candidates.append("/usr/local/cuda/bin/nvcc")
    for c in candidates:
        if os.path.isfile(c) and os.access(c, os.X_OK):
            return c
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME or put nvcc on PATH); the CUDA "
        "kernels are compiled on first use"
    )


def library_path(name: str) -> Path:
    """Build path keyed by the source, the shared headers and the flags."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    return BUILD_DIR / f"lib{name}-{h.hexdigest()[:12]}.so"


def build(name: str) -> tuple[Path, str]:
    """Compile one kernel library if it is missing. Returns (path, the
    compiler's resource report, empty when the library was already
    built)."""
    out = library_path(name)
    if out.exists():
        return out, ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.name}.{os.getpid()}.tmp")
    cmd = [find_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed for {name}.cu (exit {proc.returncode}):\n"
            f"{proc.stdout}\n{proc.stderr}"
        )
    os.replace(tmp, out)
    return out, proc.stdout + proc.stderr


def build_all() -> dict[str, str]:
    """Compile every kernel library at once (one nvcc per source)."""
    with ThreadPoolExecutor(max_workers=len(KERNELS)) as pool:
        results = list(pool.map(build, KERNELS))
    return {name: report for name, (_, report) in zip(KERNELS, results)}


@functools.lru_cache(maxsize=None)
def library(name: str) -> ctypes.CDLL:
    """The loaded shared library of kernel ``name`` (built on first use)."""
    path, _ = build(name)
    return ctypes.CDLL(str(path))


@functools.lru_cache(maxsize=None)
def kernel_fn(name: str):
    """The loaded C entry point of kernel ``name`` (built on first use)."""
    symbol, argtypes = SIGNATURES[name]
    fn = getattr(library(name), symbol)
    fn.argtypes = argtypes
    fn.restype = ctypes.c_int
    return fn


def check(name: str, code: int) -> None:
    """Raise if a launch returned a CUDA error."""
    if code != 0:
        raise RuntimeError(f"{name} kernel launch failed: cudaError_t {code}")
