"""The native tile packer (port of ``sagecal_tpu/io/native.py``).

``csrc/tile_pack.cc`` (the reference's loadData hot loop,
src/MS/data.cpp:522-664) is compiled with ``g++ -O3 -shared -fPIC`` into
``build/torch_kernels/`` on first use (the library name carries a hash
of the source, so an edited source is rebuilt and a stale library never
loads) and called through ``ctypes``. :func:`pack_tile_py` is its numpy
version with the same semantics.

Unlike the JAX package's bridge, a failed build or load raises; nothing
falls back to numpy behind the caller's back (the numpy version runs
where a caller asks for it: the tests). ``PACKS`` counts the native
packer's calls and ``LIB_PATH`` names the library that ran. Host code,
not a device kernel: the packed rows are uploaded to the card
afterwards.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from pathlib import Path

import numpy as np

C_M_S = 299792458.0

PKG_DIR = Path(__file__).resolve().parents[1]
SRC = PKG_DIR / "csrc" / "tile_pack.cc"
BUILD_DIR = PKG_DIR.parent / "build" / "torch_kernels"
CXX_FLAGS = ["-O3", "-shared", "-fPIC"]

#: calls of the native packer (a plain counter: the pipeline logs the
#: calls of its run, chip_smoke.py's multims run checks that the card
#: run made some)
PACKS = 0
#: the loaded library's path, once loaded
LIB_PATH: str | None = None
_lib = None


def lib_path() -> Path:
    digest = hashlib.sha256(SRC.read_bytes()
                            + " ".join(CXX_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"libtile_pack-{digest[:12]}.so"


def build() -> Path:
    """Compile the packer unless its library exists; raise on failure.
    The library lands by rename, so two processes compiling at once never
    load a half-written file."""
    out = lib_path()
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f"{out.stem}.{os.getpid()}.tmp.so")
    proc = subprocess.run(["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed to build {SRC}:\n{proc.stderr}")
    os.replace(tmp, out)
    return out


def get_lib() -> ctypes.CDLL:
    """The loaded packer, built on first use (raises if it cannot be)."""
    global _lib, LIB_PATH
    if _lib is not None:
        return _lib
    path = build()
    lib = ctypes.CDLL(str(path))
    lib.pack_tile.restype = None
    lib.pack_tile.argtypes = [
        ctypes.POINTER(ctypes.c_double),   # vis
        ctypes.POINTER(ctypes.c_uint8),    # cflags
        ctypes.POINTER(ctypes.c_double),   # u
        ctypes.POINTER(ctypes.c_double),   # v
        ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
        ctypes.c_double, ctypes.c_double, ctypes.c_double,
        ctypes.c_double,
        ctypes.POINTER(ctypes.c_double),   # x8
        ctypes.POINTER(ctypes.c_uint8),    # rowflag
        ctypes.POINTER(ctypes.c_double),   # fratio
    ]
    _lib, LIB_PATH = lib, str(path)
    return _lib


def pack_tile_py(vis, cflags, u_m, v_m, nrow_total: int,
                 uvmin: float = 0.0, uvmax: float = 1e30,
                 uvtaper_m: float = 0.0, freq0: float = 0.0):
    """The numpy packer (data.cpp:552-664 semantics). vis [nrow, nchan,
    2, 2] complex; cflags [nrow, nchan] (nonzero = flagged); u_m/v_m in
    METERS. Returns (x8 [nrow_total, 8] float64, rowflag [nrow_total]
    uint8, fratio)."""
    vis = np.asarray(vis)
    nrow, nchan = vis.shape[:2]
    good = np.asarray(cflags) == 0                       # [nrow, nchan]
    nflag = good.sum(axis=1)
    v4 = vis.reshape(nrow, nchan, 4)
    acc = np.where(good[..., None], v4, 0.0).sum(axis=1)  # [nrow, 4]
    uvd = np.sqrt(np.asarray(u_m) ** 2 + np.asarray(v_m) ** 2)
    taper = np.ones(nrow)
    if uvtaper_m > 0.0:
        taper = np.minimum(uvd * freq0 / (uvtaper_m * C_M_S), 1.0)
    rowgood = 2 * nflag > nchan
    avg = np.zeros((nrow, 4), complex)
    nz = np.maximum(nflag, 1)
    avg[rowgood] = (acc[rowgood] / nz[rowgood, None]
                    * taper[rowgood, None])
    rowflag = np.where(rowgood, 0, np.where(nflag == 0, 1, 2)) \
        .astype(np.uint8)
    rowflag = np.where((uvd < uvmin) | (uvd > uvmax), 2,
                       rowflag).astype(np.uint8)
    countgood = int(rowgood.sum())
    countbad = int((nflag == 0).sum())
    fratio = (countbad / (countgood + countbad)
              if countgood + countbad > 0 else 1.0)
    x8 = np.zeros((nrow_total, 8))
    x8[:nrow, 0::2] = avg.real
    x8[:nrow, 1::2] = avg.imag
    out_flags = np.ones(nrow_total, np.uint8)
    out_flags[:nrow] = rowflag
    return x8, out_flags, float(fratio)


def pack_tile(vis, cflags, u_m, v_m, nrow_total: int,
              uvmin: float = 0.0, uvmax: float = 1e30,
              uvtaper_m: float = 0.0, freq0: float = 0.0):
    """The native packer; the arguments and results of
    :func:`pack_tile_py`."""
    global PACKS
    lib = get_lib()
    vis = np.asarray(vis)
    nrow, nchan = vis.shape[:2]
    v4 = vis.reshape(nrow, nchan, 4)
    vis8 = np.ascontiguousarray(np.stack([v4.real, v4.imag], -1),
                                dtype=np.float64)
    cf = np.ascontiguousarray(np.asarray(cflags) != 0, dtype=np.uint8)
    u_m = np.ascontiguousarray(u_m, dtype=np.float64)
    v_m = np.ascontiguousarray(v_m, dtype=np.float64)
    x8 = np.zeros((nrow_total, 8))
    rowflag = np.zeros(nrow_total, np.uint8)
    fratio = ctypes.c_double(0.0)
    dptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_double))
    bptr = lambda a: a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))
    lib.pack_tile(dptr(vis8), bptr(cf), dptr(u_m), dptr(v_m), nrow, nchan,
                  nrow_total, uvmin, uvmax, uvtaper_m, freq0, dptr(x8),
                  bptr(rowflag), ctypes.byref(fratio))
    PACKS += 1
    return x8, rowflag, float(fratio.value)
