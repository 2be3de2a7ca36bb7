"""Visibility containers, the SimMS format and synthetic data (port of
``sagecal_tpu/io/dataset.py``).

- :class:`VisTile`: one solve interval, host-side numpy;
- :class:`SimMS`: the columnar on-disk dataset (``meta.json`` + one npz
  per tile). It reads a SimMS that the JAX package wrote and writes one
  the JAX package reads;
- :func:`simulate_dataset`: synthetic uvw tracks, a predicted sky,
  known Jones corruption and noise.

Not ported in this slice: the native per-channel-flag packing
(``VisTile.pack``), the multi-MS list and the casacore backend.
"""

from __future__ import annotations

import dataclasses
import json
import os

import numpy as np
import torch

from sagecal_tpu_torch import utils

C_M_S = 299792458.0
OMEGA_E = 7.2921150e-5  # earth angular velocity rad/s


@dataclasses.dataclass
class VisTile:
    """One solve interval. Rows are ordered [tilesz, nbase] flattened;
    u, v, w in seconds; ``x`` is [B, F, 2, 2] complex; ``flags`` per row
    (0 ok, 1 flagged, 2 uv-cut)."""

    u: np.ndarray
    v: np.ndarray
    w: np.ndarray
    x: np.ndarray
    flags: np.ndarray
    sta1: np.ndarray
    sta2: np.ndarray
    freqs: np.ndarray
    freq0: float
    fdelta: float
    tdelta: float
    dec0: float
    ra0: float
    n_stations: int
    nbase: int
    tilesz: int
    time_mjd: np.ndarray | None = None
    cflags: np.ndarray | None = None

    @property
    def nrows(self) -> int:
        return self.u.shape[0]

    def averaged(self):
        """Channel-averaged data [B, 2, 2]; flagged rows zeroed."""
        xa = self.x.mean(axis=1)
        xa[self.flags == 1] = 0.0
        return xa

    def solve_input(self, uvtaper_m: float = 0.0):
        """(x8 [B, 8], rowflags [B]) — the channel-averaged solve input.

        Per-channel flags and the uv taper need the native packing
        kernel, which this slice does not port."""
        if self.cflags is not None or uvtaper_m > 0.0:
            raise NotImplementedError(
                "per-channel flags / uv taper need the native tile "
                "packing (ROADMAP queue A item 7: io/native.py)")
        return utils.vis_to_x8(self.averaged()), self.flags


def row_tslot(nrows: int, nbase: int) -> np.ndarray:
    """[nrows] row -> timeslot index for [tilesz, nbase]-ordered rows."""
    return (np.arange(nrows) // nbase).astype(np.int32)


def generate_baselines(n_stations: int):
    """All cross-correlation pairs (p < q)."""
    p, q = np.triu_indices(n_stations, k=1)
    return p.astype(np.int32), q.astype(np.int32)


def uvw_tracks(xyz: np.ndarray, dec0: float, ha: np.ndarray):
    """Baseline uvw (meters) for hour angles ``ha`` [T] given station
    positions ``xyz`` [N, 3]."""
    p, q = generate_baselines(xyz.shape[0])
    bl = xyz[q] - xyz[p]
    sh, ch = np.sin(ha), np.cos(ha)
    sd, cd = np.sin(dec0), np.cos(dec0)
    u = sh[:, None] * bl[None, :, 0] + ch[:, None] * bl[None, :, 1]
    v = (-sd * ch[:, None] * bl[None, :, 0] + sd * sh[:, None] * bl[None, :, 1]
         + cd * bl[None, :, 2])
    w = (cd * ch[:, None] * bl[None, :, 0] - cd * sh[:, None] * bl[None, :, 1]
         + sd * bl[None, :, 2])
    return u, v, w, p, q


def random_array(n_stations: int, extent_m: float = 3000.0,
                 seed: int = 7) -> np.ndarray:
    """Pseudo-random LOFAR-like station layout: dense core + outliers."""
    rng = np.random.default_rng(seed)
    r = extent_m * rng.random(n_stations) ** 2
    th = 2 * np.pi * rng.random(n_stations)
    x = r * np.cos(th)
    y = r * np.sin(th)
    z = rng.normal(0.0, extent_m * 0.01, n_stations)
    return np.stack([x, y, z], axis=1)


def random_jones(n_clusters: int, n_chunks, n_stations: int, seed: int = 3,
                 scale: float = 0.3, diag_dominant: bool = True):
    """Random per-(cluster, chunk, station) 2x2 Jones [M, Kmax, N, 2, 2]."""
    rng = np.random.default_rng(seed)
    kmax = int(np.asarray(n_chunks).max())
    J = (rng.normal(size=(n_clusters, kmax, n_stations, 2, 2))
         + 1j * rng.normal(size=(n_clusters, kmax, n_stations, 2, 2))) \
        * scale
    if diag_dominant:
        J = J + np.eye(2)[None, None, None]
    return J


def simulate_dataset(sky_arrays, n_stations: int, tilesz: int,
                     freqs, ra0: float, dec0: float, tdelta: float = 10.0,
                     jones: np.ndarray | None = None, nchunk=None,
                     noise_sigma: float = 0.0, seed: int = 11,
                     extent_m: float = 3000.0,
                     flag_fraction: float = 0.0,
                     chan_width: float | None = None,
                     start_mjd_s: float = 4.93e9) -> VisTile:
    """Synthesize a corrupted dataset from a port sky model
    (:class:`rime.predict.SkyArrays`, or a ``rime.predict.SplitSky``), on
    the sky's device: per-channel model visibilities of every source
    morphology (``rime.predict.coherencies``), corrupted by ``jones`` per
    cluster, plus noise drawn with numpy from ``seed``."""
    from sagecal_tpu_torch.rime import predict as rp

    freqs = np.atleast_1d(np.asarray(freqs, np.float64))
    xyz = random_array(n_stations, extent_m=extent_m, seed=seed)
    ha = np.linspace(0.0, OMEGA_E * tdelta * tilesz, tilesz, endpoint=False)
    u, v, w, p, q = uvw_tracks(xyz, dec0, ha)
    nbase = p.shape[0]
    us = (u / C_M_S).reshape(-1)
    vs = (v / C_M_S).reshape(-1)
    ws = (w / C_M_S).reshape(-1)
    sta1 = np.tile(p, tilesz)
    sta2 = np.tile(q, tilesz)

    if chan_width is None:
        chan_width = (float(freqs[1] - freqs[0]) if len(freqs) > 1
                      else 0.18e6)
    fdelta_tot = float(freqs[-1] - freqs[0]) + chan_width
    fdelta_chan = fdelta_tot / len(freqs)
    time_mjd = start_mjd_s + tdelta * (np.arange(tilesz) + 0.5)

    ref = sky_arrays if isinstance(sky_arrays, rp.SkyArrays) else (
        sky_arrays.pg if sky_arrays.pg is not None else sky_arrays.rest)
    dev = ref.ll.device
    rdt = ref.ll.dtype
    t = lambda a: torch.as_tensor(a, dtype=rdt, device=dev)
    coh = rp.coherencies(sky_arrays, t(us), t(vs), t(ws), freqs,
                         fdelta_chan, per_channel_flux=True)
    M = coh.shape[0]
    if nchunk is None:
        nchunk = np.ones(M, np.int32)
    if jones is not None:
        cidx = torch.as_tensor(rp.chunk_indices(tilesz, nbase, nchunk),
                               device=dev, dtype=torch.long)
        Jt = torch.as_tensor(jones, device=dev).to(coh.dtype)
        s1 = torch.as_tensor(sta1, device=dev, dtype=torch.long)
        s2 = torch.as_tensor(sta2, device=dev, dtype=torch.long)
        vis = torch.zeros(coh.shape[1:], dtype=coh.dtype, device=dev)
        for m in range(M):
            vis += rp.apply_jones(coh[m], Jt[m], s1, s2, cidx[m])
    else:
        vis = coh.sum(dim=0)
    vis = vis.cpu().numpy().astype(np.complex128)
    del coh

    rng = np.random.default_rng(seed + 1)
    if noise_sigma > 0:
        vis = vis + noise_sigma * (
            rng.normal(size=vis.shape) + 1j * rng.normal(size=vis.shape))
    flags = np.zeros(us.shape[0], np.int8)
    if flag_fraction > 0:
        nf = int(flag_fraction * len(flags))
        flags[rng.choice(len(flags), nf, replace=False)] = 1

    return VisTile(
        u=us, v=vs, w=ws, x=vis, flags=flags,
        sta1=sta1, sta2=sta2, freqs=freqs, freq0=float(freqs.mean()),
        fdelta=fdelta_tot, tdelta=tdelta, dec0=dec0, ra0=ra0,
        n_stations=n_stations, nbase=nbase, tilesz=tilesz,
        time_mjd=time_mjd)


class SimMS:
    """Directory dataset: ``meta.json`` + per-tile npz files.

    ``data_column`` (default DATA) is what :meth:`read_tile` returns in
    ``VisTile.x``; :meth:`write_tile` lands in ``out_column`` (default
    CORRECTED_DATA) and keeps every other column."""

    META = "meta.json"

    @staticmethod
    def _col_key(column: str) -> str:
        norm = "".join(c if c.isalnum() else "_" for c in column.upper())
        if norm == "DATA":
            return "x"
        return "x_" + norm.lower()

    def __init__(self, path: str, data_column: str = "DATA",
                 out_column: str = "CORRECTED_DATA"):
        self.path = path
        self.data_column = data_column
        self.out_column = out_column
        with open(os.path.join(path, self.META)) as f:
            self.meta = json.load(f)

    @classmethod
    def create(cls, path: str, tiles: list) -> "SimMS":
        os.makedirs(path, exist_ok=True)
        t0 = tiles[0]
        meta = {
            "n_tiles": len(tiles), "n_stations": t0.n_stations,
            "nbase": t0.nbase, "tilesz": t0.tilesz,
            "freqs": list(map(float, t0.freqs)), "freq0": t0.freq0,
            "fdelta": t0.fdelta, "tdelta": t0.tdelta,
            "ra0": t0.ra0, "dec0": t0.dec0,
        }
        with open(os.path.join(path, cls.META), "w") as f:
            json.dump(meta, f, indent=1)
        ms = cls(path)
        for i, t in enumerate(tiles):
            ms.write_tile(i, t, column="DATA")
        return ms

    @property
    def n_tiles(self) -> int:
        return self.meta["n_tiles"]

    def read_tile(self, i: int) -> VisTile:
        m = self.meta
        with np.load(os.path.join(self.path, f"tile{i:05d}.npz")) as z:
            key = self._col_key(self.data_column)
            if key not in z.files:
                have = [k for k in z.files if k == "x" or k.startswith("x_")]
                raise ValueError(
                    f"{self.path}: column {self.data_column!r} not present "
                    f"in tile {i} (stored data keys: {have})")
            return VisTile(
                u=z["u"], v=z["v"], w=z["w"], x=z[key], flags=z["flags"],
                sta1=z["sta1"], sta2=z["sta2"],
                freqs=np.asarray(m["freqs"]), freq0=m["freq0"],
                fdelta=m["fdelta"], tdelta=m["tdelta"], dec0=m["dec0"],
                ra0=m["ra0"], n_stations=m["n_stations"], nbase=m["nbase"],
                tilesz=m["tilesz"],
                time_mjd=z["time_mjd"] if "time_mjd" in z.files else None,
                cflags=z["cflags"] if "cflags" in z.files else None)

    def write_tile(self, i: int, tile: VisTile,
                   column: str | None = None) -> None:
        """Write ``tile.x`` into ``column`` (default ``out_column``),
        keeping the file's other data columns; write-then-rename."""
        key = self._col_key(column or self.out_column)
        kw = {}
        path = os.path.join(self.path, f"tile{i:05d}.npz")
        if os.path.exists(path):
            with np.load(path) as z:
                kw = {k: z[k] for k in z.files
                      if ((k == "x" or k.startswith("x_")) and k != key)
                      or k in ("time_mjd", "cflags")}
        if tile.time_mjd is not None:
            kw["time_mjd"] = tile.time_mjd
        if tile.cflags is not None:
            kw["cflags"] = tile.cflags
        kw[key] = tile.x
        tmp = path + ".tmp.npz"
        np.savez(tmp, u=tile.u, v=tile.v, w=tile.w, flags=tile.flags,
                 sta1=tile.sta1, sta2=tile.sta2, **kw)
        os.replace(tmp, path)


def open_dataset(ms: str | None, ms_list: str | None = None,
                 data_column: str = "DATA",
                 out_column: str = "CORRECTED_DATA") -> SimMS:
    """Resolve ``-d`` into a SimMS directory. Multi-MS lists (``-f``)
    and CASA tables come with ROADMAP queue A item 7."""
    if ms_list:
        raise NotImplementedError(
            "-f dataset lists are not ported yet (ROADMAP queue A item 7)")
    if not ms:
        raise ValueError("open_dataset: need -d dataset")
    if not os.path.isfile(os.path.join(ms, SimMS.META)):
        raise NotImplementedError(
            f"{ms} is not a SimMS directory; CASA MeasurementSets are not "
            "ported yet (ROADMAP queue A item 7: io/casams.py)")
    return SimMS(ms, data_column=data_column, out_column=out_column)
