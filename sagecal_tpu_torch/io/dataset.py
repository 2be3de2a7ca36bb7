"""Visibility containers, the SimMS format and synthetic data (port of
``sagecal_tpu/io/dataset.py``).

- :class:`VisTile`: one solve interval, host-side numpy;
- :class:`SimMS`: the columnar on-disk dataset (``meta.json`` + one npz
  per tile). It reads a SimMS that the JAX package wrote and writes one
  the JAX package reads;
- :class:`MultiSimMS`: several SimMS subbands as one dataset with the
  combined channel axis (``-f``), written back per part;
- :func:`open_dataset`: ``-d`` or ``-f`` (a list file or a glob);
- :func:`simulate_dataset`: synthetic uvw tracks, a predicted sky (with
  the station beam under ``dobeam``), known Jones corruption, noise and
  row and channel flags.

Per-channel flags and the uv taper reach the solve through the native
tile packer (:meth:`VisTile.pack`, ``io/native.py``). CASA
MeasurementSets (``io/casams.py`` of the JAX package) need
python-casacore, which is not installed: such a path raises as it does
there without it.
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

    @property
    def flag_ratio(self) -> float:
        """Fraction of flagged rows (data.cpp:659-663 ``fratio``)."""
        return float(np.mean(self.flags == 1))

    @property
    def time_jd(self) -> np.ndarray:
        """Per-timeslot Julian date in days (MS TIME is MJD seconds); the
        J2000 epoch when the tile carries no times."""
        if self.time_mjd is None:
            return np.full(self.tilesz, 2451545.0)
        return np.asarray(self.time_mjd) / 86400.0 + 2400000.5

    @property
    def tslot(self) -> np.ndarray:
        """[nrows] row -> timeslot index."""
        return row_tslot(self.nrows, self.nbase)

    def averaged(self):
        """Channel-averaged data [B, 2, 2]; flagged rows zeroed."""
        xa = self.x.mean(axis=1)
        xa[self.flags == 1] = 0.0
        return xa

    def solve_input(self, uvtaper_m: float = 0.0):
        """(x8 [B, 8], rowflags [B], unflagged fraction) — the
        channel-averaged solve input with loadData's semantics: the native
        tile packer (more-than-half rule, taper; the fraction its fratio's
        complement) when the tile has per-channel flags or a taper is
        asked for, else the plain channel mean (1 - :attr:`flag_ratio`).
        Stored uv-cut rows (flag 2) survive either path."""
        if self.cflags is not None or uvtaper_m > 0.0:
            x8, rowflags, fr = self.pack(uvtaper_m=uvtaper_m)
            rowflags = np.where((self.flags == 2) & (rowflags == 0),
                                np.int8(2), rowflags.astype(np.int8))
            return x8, rowflags, 1.0 - fr
        return (utils.vis_to_x8(self.averaged()), self.flags,
                1.0 - self.flag_ratio)

    def pack(self, uvmin_m: float = 0.0, uvmax_m: float = 1e30,
             uvtaper_m: float = 0.0):
        """loadData packing (data.cpp:552-664) by the native packer
        (``io/native.py``): the per-channel-flag average under the
        more-than-half rule, uv-cut and partial rows flag 2, the
        short-baseline taper, the flag ratio. u/v in seconds become
        meters; rows flagged in ``flags`` stay flagged. Returns (x8 [B,
        8] float64, rowflags [B] uint8, fratio)."""
        from sagecal_tpu_torch.io import native as nat
        cf = self.cflags
        if cf is None:
            cf = np.zeros((self.nrows, len(self.freqs)), np.uint8)
        cf = cf | (self.flags == 1)[:, None]
        return nat.pack_tile(self.x, cf, self.u * C_M_S, self.v * C_M_S,
                             self.nrows, uvmin=uvmin_m, uvmax=uvmax_m,
                             uvtaper_m=uvtaper_m, freq0=self.freq0)


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
                     chan_flag_fraction: float = 0.0,
                     chan_width: float | None = None,
                     beam=None, dobeam: int = 0,
                     start_mjd_s: float = 4.93e9) -> VisTile:
    """Synthesize a corrupted dataset from a port sky model
    (:class:`rime.predict.SkyArrays`, or a ``rime.predict.SplitSky``), on
    the sky's device: per-channel model visibilities of every source
    morphology (``rime.predict.coherencies``; with ``beam``, a
    ``rime.beam.BeamArrays`` of ``tilesz`` times, and ``dobeam``, through
    the station beam), corrupted by ``jones`` per cluster, plus noise and
    row and channel flags drawn with numpy from ``seed``."""
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
    beam_kw = {}
    if beam is not None and dobeam:
        if beam.gmst.shape[0] != tilesz:
            raise ValueError(
                f"beam staged with {beam.gmst.shape[0]} timeslots but "
                f"tilesz={tilesz}")
        lng = lambda a: torch.as_tensor(a, device=dev, dtype=torch.long)
        beam_kw = dict(beam=beam, dobeam=dobeam,
                       tslot=lng(row_tslot(us.shape[0], nbase)),
                       sta1=lng(sta1), sta2=lng(sta2))
    coh = rp.coherencies(sky_arrays, t(us), t(vs), t(ws), freqs,
                         fdelta_chan, per_channel_flux=True, **beam_kw)
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
    cflags = None
    if chan_flag_fraction > 0:
        cflags = (rng.random((us.shape[0], len(freqs)))
                  < chan_flag_fraction).astype(np.uint8)

    return VisTile(
        u=us, v=vs, w=ws, x=vis, flags=flags,
        sta1=sta1, sta2=sta2, freqs=freqs, freq0=float(freqs.mean()),
        fdelta=fdelta_tot, tdelta=tdelta, dec0=dec0, ra0=ra0,
        n_stations=n_stations, nbase=nbase, tilesz=tilesz,
        time_mjd=time_mjd, cflags=cflags)


class SimMS:
    """Directory dataset: ``meta.json`` + per-tile npz files.

    ``data_column`` (default DATA) is what :meth:`read_tile` returns in
    ``VisTile.x``; :meth:`write_tile` lands in ``out_column`` (default
    CORRECTED_DATA) and keeps every other column. A ``beam.npz`` beside
    the tiles holds the station beam's metadata."""

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
    def create(cls, path: str, tiles: list, beam_info=None) -> "SimMS":
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
        if beam_info is not None:
            from sagecal_tpu_torch.rime import beam as bm
            bm.save_beaminfo(os.path.join(path, "beam.npz"), beam_info)
        return ms

    def beam_info(self):
        """The stored beam metadata (``rime.beam.BeamInfo``) or None."""
        p = os.path.join(self.path, "beam.npz")
        if not os.path.exists(p):
            return None
        from sagecal_tpu_torch.rime import beam as bm
        return bm.load_beaminfo(p)

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


class MultiSimMS:
    """Several SimMS datasets as ONE dataset with the combined channel
    axis: ``-f``'s multi-MS joint calibration (``Data::loadDataList``,
    data.cpp:835, averages over every MS's channels, the more-than-half
    rule counting unflagged channels over all of them; ``writeDataList``,
    data.cpp:1304, splits the residual's channels back per MS). The
    parts must agree on stations, baselines and tiles; they are ordered
    by mean frequency."""

    def __init__(self, paths, tilesz: int = 10, data_column: str = "DATA",
                 out_column: str = "CORRECTED_DATA"):
        if isinstance(paths, str):
            paths = [paths]
        if not paths:
            raise ValueError("MultiSimMS: empty dataset list")
        parts = [open_part(p, tilesz, data_column, out_column)
                 for p in paths]
        parts.sort(key=lambda m: float(np.mean(m.meta["freqs"])))
        m0 = parts[0].meta
        for mx in parts[1:]:
            for key in ("n_stations", "nbase", "tilesz", "n_tiles",
                        "tdelta", "ra0", "dec0"):
                if mx.meta[key] != m0[key]:
                    raise ValueError(
                        f"dataset {mx.path}: {key} mismatch "
                        f"({mx.meta[key]} vs {m0[key]})")
        self.parts = parts
        self.path = ",".join(p.path for p in parts)
        freqs = np.concatenate([np.asarray(p.meta["freqs"], float)
                                for p in parts])
        self._nchan = [len(p.meta["freqs"]) for p in parts]
        self.meta = dict(m0)
        self.meta["freqs"] = list(map(float, freqs))
        # freq0: the mean over every channel of every MS
        # (readAuxDataList, data.cpp:487-505)
        self.meta["freq0"] = float(freqs.mean())
        self.meta["fdelta"] = float(sum(p.meta["fdelta"] for p in parts))

    @property
    def n_tiles(self) -> int:
        return self.meta["n_tiles"]

    def beam_info(self):
        return self.parts[0].beam_info()

    def read_tile(self, i: int) -> VisTile:
        tiles = [p.read_tile(i) for p in self.parts]
        t0 = tiles[0]
        x = np.concatenate([t.x for t in tiles], axis=1)
        # a row is flagged only where every MS flags it; the uv cut (2)
        # only where nothing is plain-flagged
        allf = np.stack([t.flags for t in tiles])
        flags = np.zeros(t0.nrows, np.int8)
        flags[np.all(allf == 1, axis=0)] = 1
        flags[np.any(allf == 2, axis=0) & (flags == 0)] = 2
        # a row flagged in one MS must not enter the channel average
        # (data.cpp:899-921): channel flags from each part's row flags
        # whenever the parts disagree or any part has channel flags
        flags_differ = not all(
            np.array_equal(t.flags, tiles[0].flags) for t in tiles[1:])
        cfl = None
        if flags_differ or any(t.cflags is not None for t in tiles):
            cfl = np.concatenate(
                [((t.cflags if t.cflags is not None
                   else np.zeros((t.nrows, len(t.freqs)), np.uint8))
                  | (t.flags == 1)[:, None].astype(np.uint8))
                 for t in tiles], axis=1)
        return VisTile(
            u=t0.u, v=t0.v, w=t0.w, x=x, flags=flags,
            sta1=t0.sta1, sta2=t0.sta2,
            freqs=np.asarray(self.meta["freqs"]),
            freq0=self.meta["freq0"], fdelta=self.meta["fdelta"],
            tdelta=t0.tdelta, dec0=t0.dec0, ra0=t0.ra0,
            n_stations=t0.n_stations, nbase=t0.nbase, tilesz=t0.tilesz,
            time_mjd=t0.time_mjd, cflags=cfl)

    def write_tile(self, i: int, tile: VisTile) -> None:
        """The combined channels back into each part (writeDataList);
        each part keeps its own flags."""
        lo = 0
        for p, nc in zip(self.parts, self._nchan):
            part_tile = p.read_tile(i)
            part_tile.x = tile.x[:, lo:lo + nc]
            p.write_tile(i, part_tile)
            lo += nc


def is_ms_path(path: str) -> bool:
    """A CASA table is a directory holding ``table.dat``."""
    return os.path.isdir(path) and os.path.exists(
        os.path.join(path, "table.dat"))


def open_part(path: str, tilesz: int = 10, data_column: str = "DATA",
              out_column: str = "CORRECTED_DATA") -> SimMS:
    """One dataset path -> SimMS. A CASA table raises: without
    python-casacore as the JAX package does, and with it because its
    backend (``io/casams.py``) is not ported."""
    if is_ms_path(path):
        try:
            import casacore  # noqa: F401
        except ImportError:
            raise RuntimeError(
                f"{path} is a CASA table but python-casacore is not "
                f"installed; install it or convert to a SimMS directory")
        raise NotImplementedError(
            f"{path} is a CASA table: the casacore backend (io/casams.py) "
            "is not ported")
    return SimMS(path, data_column=data_column, out_column=out_column)


def open_dataset(ms: str | None, ms_list: str | None = None,
                 tilesz: int = 10, data_column: str = "DATA",
                 out_column: str = "CORRECTED_DATA"):
    """``-d`` or ``-f`` -> a dataset: one SimMS, or a :class:`MultiSimMS`
    of the paths in a list file (one a line, ``#`` comments) or matched
    by a glob. ``-f`` wins over ``-d`` (the reference's loadDataList
    order); one listed path opens alone. ``tilesz`` is a CASA table's
    (a SimMS stores its own)."""
    if ms and not ms_list:
        return open_part(ms, tilesz, data_column, out_column)
    if ms_list:
        import glob as globmod
        if os.path.isfile(ms_list):
            with open(ms_list) as f:
                stripped = (ln.strip() for ln in f)
                paths = [ln for ln in stripped
                         if ln and not ln.startswith("#")]
        else:
            paths = sorted(globmod.glob(ms_list))
        if not paths:
            raise ValueError(f"-f {ms_list}: no datasets found")
        if len(paths) == 1:
            return open_part(paths[0], tilesz, data_column, out_column)
        return MultiSimMS(paths, tilesz=tilesz, data_column=data_column,
                          out_column=out_column)
    raise ValueError("open_dataset: need -d dataset or -f list")
