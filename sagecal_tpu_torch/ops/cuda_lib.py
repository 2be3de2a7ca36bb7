"""Build and load the port's hand-written CUDA kernels.

Each source ``csrc/<name>.cu`` has a plain C interface and becomes its
own shared library, compiled by ``nvcc`` for Hopper (``sm_90a``) into
``build/torch_kernels/`` at the repository root on first use, and loaded
with ``ctypes``. The library name carries a hash of its source, so an
edited kernel is rebuilt and a stale one is never loaded. All sources
are compiled together (one ``nvcc`` process each, started at once).

Nothing here runs at import time: this module is imported on machines
without ``nvcc`` or a card, where only the kernels' plain PyTorch
versions run.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[1]
CSRC = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR.parent / "build" / "torch_kernels"
SOURCES = ("coh", "sweep", "matvec")

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong

# C signatures: every launch returns cudaGetLastError() as an int
SIGNATURES = {
    "coh": {
        # uvw3, geom, flux, gauss, freqs, fdelta, step, out, M, F, B, S,
        # the geometry ft, tile, n_tiles, row_blocks (ops/coh.py:
        # coh_geometry), recur, stream
        "coh_points_launch": [_P, _P, _P, _P, _P, _F, _F, _P, _I, _I, _I,
                              _I, _I, _I, _I, _I, _I, _P],
    },
    "sweep": {
        # x, w, cw, cid, coh, J, s1, s2, out, cost, tile costs, ticket,
        # T, nb, K, N, V, md (the Jones mode's block width), st (the rows'
        # storage: 0 float32, 1 bf16, 2 f16), the visit strides [6] of x,
        # w, cw, cid, coh, J (0 = shared), cluster, its time bounds
        # [cluster + 1] and word bounds [2][9]
        # (ops/sweep.py:sweep_geometry), stream
        "sweep_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I,
                         _I, _I, _I, _I, _I, _I, _P, _I, _P, _P, _P],
        # (K, md, st) -> blocks of the sweep kernel an SM holds
        "sweep_blocks_per_sm": [_I, _I, _I],
    },
    "matvec": {
        # &MatvecParams, v, y, stream
        "matvec_launch": [_P, _P, _P, _P],
    },
}


class MatvecParams(ctypes.Structure):
    """The fixed arguments of ``csrc/matvec.cu``'s launch (its C struct
    ``MatvecParams``), filled once per Gram-block set."""

    _fields_ = [("pp", _P), ("qq", _P), ("pq", _P), ("sp", _L), ("sq", _L),
                ("spq", _L), ("s1", _P), ("s2", _P), ("runs", _P),
                ("ent", _P), ("shift", _P), ("K", _I), ("nb", _I),
                ("N", _I), ("md", _I)]

_LIBS: dict = {}


def _nvcc() -> str:
    path = shutil.which("nvcc")
    if path is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        path = "/usr/local/cuda/bin/nvcc"
    if path is None:
        raise RuntimeError("nvcc not found (neither on PATH nor in "
                           "/usr/local/cuda/bin): the CUDA kernels cannot "
                           "be built")
    return path


def _lib_path(name: str) -> Path:
    digest = hashlib.sha256((CSRC / f"{name}.cu").read_bytes()
                            + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}-{digest[:12]}.so"


def build_paths(out: Path, pid: int | None = None) -> tuple:
    """(library, report) that process ``pid`` (this one by default)
    compiles into before renaming them to ``out`` and ``<out>.log``: a
    name of its own, so that processes building at once (the ranks of a
    multi-process run on a fresh checkout) never replace a file another
    ``nvcc`` is still writing."""
    pid = os.getpid() if pid is None else pid
    return (out.with_name(f"{out.stem}.{pid}.tmp.so"),
            out.with_name(f"{out.stem}.{pid}.tmp.log"))


def build_all() -> dict:
    """Compile every source whose library is missing, all at once.
    Returns {name: seconds} for the sources built in this call; the
    compiler's register/spill report lands in ``<lib>.log``. Each
    process compiles into files of its own (:func:`build_paths`) and
    renames them into place, the report first."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    todo = {n: _lib_path(n) for n in SOURCES if not _lib_path(n).exists()}
    if not todo:
        return {}
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for name, out in todo.items():
        tmp, tmp_log = build_paths(out)
        log = open(tmp_log, "w")
        procs[name] = (subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT), log, out)
    failed, seconds = [], {}
    for name, (proc, log, out) in procs.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        tmp, tmp_log = build_paths(out)
        if rc != 0:
            failed.append((name, tmp_log.read_text()))
        else:
            os.replace(tmp_log, out.with_suffix(".log"))
            os.replace(tmp, out)
    if failed:
        raise RuntimeError(f"nvcc failed for {[n for n, _ in failed]}:\n"
                           + "\n".join(text for _, text in failed))
    return seconds


def build_log(name: str) -> str:
    """The compiler's report (registers, spills) for ``name``."""
    p = _lib_path(name).with_suffix(".log")
    return p.read_text() if p.exists() else ""


def load(name: str) -> ctypes.CDLL:
    """The loaded library for source ``name``, built on first use."""
    lib = _LIBS.get(name)
    if lib is not None:
        return lib
    build_all()
    lib = ctypes.CDLL(str(_lib_path(name)))
    for fn, argtypes in SIGNATURES[name].items():
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    _LIBS[name] = lib
    return lib


def check(rc: int, what: str) -> None:
    """Raise on a launch whose cudaGetLastError() was not cudaSuccess."""
    if rc != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError {rc}")


def stream_ptr(device) -> int:
    """The raw handle of PyTorch's current stream on ``device``, from the
    raw-stream query PyTorch's own compiled kernels launch with (cheaper
    a call than building a ``torch.cuda.Stream``)."""
    import torch
    idx = torch.device(device).index
    return torch._C._cuda_getCurrentRawStream(
        torch.cuda.current_device() if idx is None else idx)
