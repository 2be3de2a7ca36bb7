"""Sky model + cluster file parsing (port of ``sagecal_tpu/skymodel.py``).

A numpy-only copy of the JAX package's parser (the port never imports
``sagecal_tpu``): LSM text format, cluster files, and the padded
[M, Smax] struct-of-arrays :class:`ClusterSky` the predict layer ships
to the device, and the split of a mixed sky into the coherency
kernel's point/gaussian half and a compact rest
(:func:`split_for_kernel`), and the ``-z`` ignore list
(:func:`read_ignore_list`).
"""

from __future__ import annotations

import dataclasses
import math
import os

import numpy as np

# Source morphology codes (parity with reference Radio.h:58-62)
STYPE_POINT = 0
STYPE_GAUSSIAN = 1
STYPE_DISK = 2
STYPE_RING = 3
STYPE_SHAPELET = 4

PROJ_CUT = 0.998  # reference Dirac_common.h:86


@dataclasses.dataclass
class Source:
    """One parsed sky-model entry (host side, pre-padding)."""

    name: str
    ra: float
    dec: float
    ll: float
    mm: float
    nn: float          # sqrt(1-l^2-m^2) - 1
    sI: float          # Stokes at data reference frequency
    sQ: float
    sU: float
    sV: float
    sI0: float         # catalog Stokes at f0
    sQ0: float
    sU0: float
    sV0: float
    spec_idx: float
    spec_idx1: float
    spec_idx2: float
    f0: float
    stype: int = STYPE_POINT
    eX: float = 0.0
    eY: float = 0.0
    eP: float = 0.0
    # projection rotation (readsky.c:390-418): phi=acos(n), xi=atan2(-l,m)
    cxi: float = 1.0
    sxi: float = 0.0
    cphi: float = 1.0
    sphi: float = 0.0
    use_projection: bool = False
    sh_n0: int = 0
    sh_beta: float = 1.0
    sh_modes: np.ndarray | None = None


@dataclasses.dataclass
class ClusterSky:
    """Padded [M, Smax] sky model; the device-side source of truth.

    ``smask`` marks live sources; padded slots have zero flux so they are
    harmless if ever summed. ``cluster_ids`` keeps the user-facing id
    (negative => solved for but never subtracted, README.md:50).
    """

    cluster_ids: np.ndarray        # [M] int32
    nchunk: np.ndarray             # [M] int32 hybrid time-chunk counts
    names: list                    # [M] list[list[str]] source names (host only)

    ll: np.ndarray                 # [M, Smax]
    mm: np.ndarray
    nn: np.ndarray                 # carries the -1
    ra: np.ndarray                 # [M, Smax] rad (for beam evaluation)
    dec: np.ndarray
    sI: np.ndarray                 # [M, Smax] Stokes at data ref freq
    sQ: np.ndarray
    sU: np.ndarray
    sV: np.ndarray
    sI0: np.ndarray                # catalog values at f0
    sQ0: np.ndarray
    sU0: np.ndarray
    sV0: np.ndarray
    spec_idx: np.ndarray
    spec_idx1: np.ndarray
    spec_idx2: np.ndarray
    f0: np.ndarray

    stype: np.ndarray              # [M, Smax] int32
    eX: np.ndarray
    eY: np.ndarray
    eP: np.ndarray
    cxi: np.ndarray
    sxi: np.ndarray
    cphi: np.ndarray
    sphi: np.ndarray
    use_projection: np.ndarray     # [M, Smax] bool

    sh_n0: np.ndarray              # [M, Smax] int32, 0 for non-shapelets
    sh_beta: np.ndarray            # [M, Smax]
    sh_modes: np.ndarray           # [M, Smax, n0max^2]

    smask: np.ndarray              # [M, Smax] bool

    @property
    def n_clusters(self) -> int:
        return int(self.cluster_ids.shape[0])

    @property
    def max_sources(self) -> int:
        return int(self.smask.shape[1])

    @property
    def n_eff_clusters(self) -> int:
        """Mt = sum(nchunk): effective cluster count after hybrid chunking."""
        return int(self.nchunk.sum())

    def subtract_mask(self) -> np.ndarray:
        """[M] bool: clusters that are subtracted from the data (id >= 0)."""
        return self.cluster_ids >= 0


def _parse_hms(h, m, s) -> float:
    """Hours-minutes-seconds -> radians, sign carried by the hours field."""
    sign = -1.0 if h < 0 else 1.0
    return sign * (abs(h) + m / 60.0 + s / 3600.0) * math.pi / 12.0


def _parse_dms(d, m, s, neg_zero: bool) -> float:
    sign = -1.0 if (d < 0 or neg_zero) else 1.0
    return sign * (abs(d) + m / 60.0 + s / 3600.0) * math.pi / 180.0


def _scaled_flux(s0: float, fratio: float, fratio1: float, fratio2: float,
                 si: float, si1: float, si2: float) -> float:
    """exp-log spectral scaling with sign passthrough (readsky.c:347-370)."""
    if si == 0.0 and si1 == 0.0 and si2 == 0.0:
        return s0
    if s0 == 0.0:
        return 0.0
    mag = math.exp(math.log(abs(s0)) + si * fratio + si1 * fratio1 + si2 * fratio2)
    return mag if s0 > 0 else -mag


def read_shapelet_modes(name: str, directory: str = "."):
    """Parse ``<name>.fits.modes`` (readsky.c:149): header ra/dec (ignored),
    then ``n0 beta``, then n0^2 ``index value`` rows."""
    path = os.path.join(directory, name + ".fits.modes")
    with open(path) as f:
        tokens = f.read().split()
    # 6 ra/dec tokens, then n0, beta
    n0 = int(tokens[6])
    beta = float(tokens[7])
    vals = tokens[8:]
    modes = np.zeros(n0 * n0)
    for ci in range(n0 * n0):
        modes[ci] = float(vals[2 * ci + 1])
    return n0, beta, modes


def parse_sky_model(path: str, ra0: float, dec0: float, freq0: float,
                    format_3: bool = False,
                    shapelet_dir: str | None = None) -> dict:
    """Parse an LSM sky-model text file -> {name: Source}.

    ``freq0`` is the data reference frequency: fluxes are pre-scaled to it
    exactly as readsky.c:347-376 while the catalog values are retained for
    per-channel scaling. ``format_3`` selects the 3rd-order spectral-index
    variant (``-F 1``).
    """
    if shapelet_dir is None:
        shapelet_dir = os.path.dirname(os.path.abspath(path))
    sources: dict[str, Source] = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or line.startswith("//"):
                continue
            tok = line.split()
            if format_3:
                if len(tok) < 19:
                    continue
                (name, rahr, ramin, rasec, decd, decmin, decsec,
                 sI, sQ, sU, sV, si, si1, si2, _rm, eX, eY, eP, f0) = (
                    tok[0], *map(float, tok[1:19]))
            else:
                if len(tok) < 17:
                    continue
                (name, rahr, ramin, rasec, decd, decmin, decsec,
                 sI, sQ, sU, sV, si, _rm, eX, eY, eP, f0) = (
                    tok[0], *map(float, tok[1:17]))
                si1 = si2 = 0.0
            if f0 <= 0.0:
                raise ValueError(
                    f"source {name}: reference freq must be positive "
                    f"(parsed f0={f0}; wrong column count for format_3="
                    f"{format_3}? The 3rd-order spectral-index format needs "
                    f"format_3=True / -F 1)")

            ra = _parse_hms(rahr, ramin, rasec)
            dec = _parse_dms(decd, decmin, decsec, tok[4].startswith("-"))
            ll = math.cos(dec) * math.sin(ra - ra0)
            mm = (math.sin(dec) * math.cos(dec0)
                  - math.cos(dec) * math.sin(dec0) * math.cos(ra - ra0))
            nn_full = math.sqrt(max(1.0 - ll * ll - mm * mm, 0.0))

            fr = math.log(freq0 / f0)
            fr1, fr2 = fr * fr, fr * fr * fr
            s = Source(
                name=name, ra=ra, dec=dec, ll=ll, mm=mm, nn=nn_full - 1.0,
                sI=_scaled_flux(sI, fr, fr1, fr2, si, si1, si2),
                sQ=_scaled_flux(sQ, fr, fr1, fr2, si, si1, si2),
                sU=_scaled_flux(sU, fr, fr1, fr2, si, si1, si2),
                sV=_scaled_flux(sV, fr, fr1, fr2, si, si1, si2),
                sI0=sI, sQ0=sQ, sU0=sU, sV0=sV,
                spec_idx=si, spec_idx1=si1, spec_idx2=si2, f0=f0)

            # morphology from the leading character of the name (readsky.c:405)
            lead = name[0].upper()
            if lead in ("G", "D", "R", "S"):
                phi = math.acos(nn_full)
                xi = math.atan2(-ll, mm)
                s.cxi, s.sxi = math.cos(xi), math.sin(-xi)
                s.cphi, s.sphi = math.cos(phi), math.sin(-phi)
                s.use_projection = nn_full < PROJ_CUT
                s.eP = eP
                if lead == "G":
                    s.stype = STYPE_GAUSSIAN
                    s.eX, s.eY = 2.0 * eX, 2.0 * eY  # readsky.c:412-413
                elif lead == "D":
                    s.stype = STYPE_DISK
                    s.eX = s.eY = eX
                elif lead == "R":
                    s.stype = STYPE_RING
                    s.eX = s.eY = eX
                else:
                    s.stype = STYPE_SHAPELET
                    s.eX = eX if eX else 1.0
                    s.eY = eY if eY else 1.0
                    s.sh_n0, s.sh_beta, s.sh_modes = read_shapelet_modes(
                        name, shapelet_dir)
            sources[name] = s
    return sources


def parse_cluster_file(path: str) -> list:
    """Parse cluster file: ``cluster_id chunk_size name...`` per line."""
    clusters = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#") or line.startswith("//"):
                continue
            tok = line.split()
            if len(tok) < 3:
                continue
            clusters.append((int(tok[0]), int(tok[1]), tok[2:]))
    return clusters


def build_cluster_sky(sources: dict, clusters: list,
                      dtype=np.float64) -> ClusterSky:
    """Assemble parsed sources + cluster spec into a padded ClusterSky."""
    M = len(clusters)
    smax = max(len(names) for _, _, names in clusters)
    n0max = 1
    for _, _, names in clusters:
        for nm in names:
            s = sources[nm]
            if s.sh_n0:
                n0max = max(n0max, s.sh_n0)

    def zeros(shape=(M, smax)):
        return np.zeros(shape, dtype=dtype)

    c = ClusterSky(
        cluster_ids=np.zeros(M, np.int32), nchunk=np.ones(M, np.int32),
        names=[],
        ll=zeros(), mm=zeros(), nn=zeros(), ra=zeros(), dec=zeros(),
        sI=zeros(), sQ=zeros(), sU=zeros(), sV=zeros(),
        sI0=zeros(), sQ0=zeros(), sU0=zeros(), sV0=zeros(),
        spec_idx=zeros(), spec_idx1=zeros(), spec_idx2=zeros(),
        f0=np.ones((M, smax), dtype=dtype),
        stype=np.zeros((M, smax), np.int32),
        eX=zeros(), eY=zeros(), eP=zeros(),
        cxi=np.ones((M, smax), dtype=dtype), sxi=zeros(),
        cphi=np.ones((M, smax), dtype=dtype), sphi=zeros(),
        use_projection=np.zeros((M, smax), bool),
        sh_n0=np.zeros((M, smax), np.int32),
        sh_beta=np.ones((M, smax), dtype=dtype),
        sh_modes=np.zeros((M, smax, n0max * n0max), dtype=dtype),
        smask=np.zeros((M, smax), bool),
    )
    for ci, (cid, nchunk, names) in enumerate(clusters):
        c.cluster_ids[ci] = cid
        c.nchunk[ci] = max(1, nchunk)
        c.names.append(list(names))
        for sj, nm in enumerate(names):
            if nm not in sources:
                raise KeyError(f"cluster {cid}: source {nm!r} not in sky model")
            s = sources[nm]
            c.ll[ci, sj], c.mm[ci, sj], c.nn[ci, sj] = s.ll, s.mm, s.nn
            c.ra[ci, sj], c.dec[ci, sj] = s.ra, s.dec
            c.sI[ci, sj], c.sQ[ci, sj] = s.sI, s.sQ
            c.sU[ci, sj], c.sV[ci, sj] = s.sU, s.sV
            c.sI0[ci, sj], c.sQ0[ci, sj] = s.sI0, s.sQ0
            c.sU0[ci, sj], c.sV0[ci, sj] = s.sU0, s.sV0
            c.spec_idx[ci, sj] = s.spec_idx
            c.spec_idx1[ci, sj] = s.spec_idx1
            c.spec_idx2[ci, sj] = s.spec_idx2
            c.f0[ci, sj] = s.f0
            c.stype[ci, sj] = s.stype
            c.eX[ci, sj], c.eY[ci, sj], c.eP[ci, sj] = s.eX, s.eY, s.eP
            c.cxi[ci, sj], c.sxi[ci, sj] = s.cxi, s.sxi
            c.cphi[ci, sj], c.sphi[ci, sj] = s.cphi, s.sphi
            c.use_projection[ci, sj] = s.use_projection
            if s.stype == STYPE_SHAPELET:
                c.sh_n0[ci, sj] = s.sh_n0
                c.sh_beta[ci, sj] = s.sh_beta
                # re-grid the n0-stride mode vector onto the padded
                # n0max-stride grid so mode (n2, n1) keeps its identity
                grid = np.zeros((n0max, n0max), dtype=dtype)
                grid[: s.sh_n0, : s.sh_n0] = np.asarray(
                    s.sh_modes).reshape(s.sh_n0, s.sh_n0)
                c.sh_modes[ci, sj] = grid.ravel()
            c.smask[ci, sj] = True
    return c


def read_sky_cluster(sky_path: str, cluster_path: str, ra0: float,
                     dec0: float, freq0: float, format_3: bool = False,
                     dtype=np.float64) -> ClusterSky:
    """One-call equivalent of reference ``read_sky_cluster`` (readsky.c:195)."""
    sources = parse_sky_model(sky_path, ra0, dec0, freq0, format_3)
    clusters = parse_cluster_file(cluster_path)
    return build_cluster_sky(sources, clusters, dtype=dtype)


def split_for_kernel(sky: ClusterSky):
    """Split a model into (point+gaussian, rest) for the hybrid predict
    (``skymodel.split_for_pallas`` of the JAX package).

    The coherency kernel (``ops/coh.py``) covers point and gaussian
    sources; shapelet, disk and ring sources go to the generic predict.
    Returns ``(sky_pg, sky_rest)``: ``sky_pg`` is the input with the other
    sources masked out (``smask``), ``sky_rest`` a compact repack (Smax =
    the largest per-cluster rest count) of the remaining live sources,
    with ``f0`` filled with 1.0 (``log(freq / f0)`` stays finite), ``smask``
    with False and every other field with 0; or None when every live
    source is a point or a gaussian. Cluster order, ``cluster_ids``,
    ``nchunk`` and ``names`` are kept on both halves, so their coherencies
    add elementwise."""
    is_pg = ((sky.stype == STYPE_POINT) | (sky.stype == STYPE_GAUSSIAN)) \
        & sky.smask
    rest = sky.smask & ~is_pg
    sky_pg = dataclasses.replace(sky, smask=is_pg)
    nrest = rest.sum(axis=1)
    if nrest.max() == 0:
        return sky_pg, None
    M = sky.smask.shape[0]
    S2 = int(nrest.max())

    def pack(a, fill=0.0):
        out = np.full((M, S2) + a.shape[2:], fill, a.dtype)
        for m in range(M):
            idx = np.where(rest[m])[0]
            out[m, : len(idx)] = a[m, idx]
        return out

    fields = {}
    for f in dataclasses.fields(sky):
        a = getattr(sky, f.name)
        if f.name in ("cluster_ids", "nchunk", "names"):
            fields[f.name] = a
        elif f.name == "smask":
            fields[f.name] = pack(a, fill=False)
        elif f.name == "f0":
            fields[f.name] = pack(a, fill=1.0)
        else:
            fields[f.name] = pack(a)
    return sky_pg, ClusterSky(**fields)


def read_cluster_rho(path: str, cluster_ids, default_rho: float = 5.0):
    """Per-cluster regularization file ``cluster_id hybrid rho`` (or
    ``cluster_id rho``; ``#`` comments) -> rho [M] float64 in
    ``cluster_ids`` order, a missing cluster at ``default_rho``
    (readsky.c:780; ``-G``)."""
    table = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            if len(tok) >= 3:
                table[int(tok[0])] = float(tok[2])
            elif len(tok) == 2:
                table[int(tok[0])] = float(tok[1])
    return np.array([table.get(int(cid), default_rho)
                     for cid in cluster_ids])


def read_ignore_list(path: str) -> set:
    """Cluster ids to leave out of a simulation (``-z``; readsky.c:743):
    the first integer of every line that is neither empty nor a
    ``#`` comment."""
    ignore = set()
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            ignore.add(int(line.split()[0]))
    return ignore


def correct_cluster_index(sky, ccid, warn=None):
    """-k cluster id -> padded-array index, or None (with a warning)
    when the id is absent — an explicitly requested correction that
    resolves to nothing must not be silent (residual.c correction
    path picks the cluster by its id column)."""
    if ccid is None:
        return None
    matches = np.where(sky.cluster_ids == ccid)[0]
    if not len(matches):
        (warn or print)(
            f"Warning: -k cluster id {ccid} not in the cluster file; "
            f"writing uncorrected residuals")
        return None
    return int(matches[0])
