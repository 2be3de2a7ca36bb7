"""Solution-file persistence (port of ``sagecal_tpu/io/solutions.py``).

The reference's text format, byte for byte as the JAX package writes
it: ``#`` comments, a header line ``freq(MHz) bandwidth(MHz)
time_interval(min) stations clusters effective_clusters``, then per
solve interval 8N rows of one column per effective cluster (the
stochastic multi-band variant adds channels and mini-bands to the header
and holds every mini-band's columns in turn in each row). The 8 reals
per station map to the 2x2 Jones as ``[S0+jS1, S4+jS5; S2+jS3, S6+jS7]``.
:func:`read_warm_start` reads the ``-q`` warm start.

The text format truncates mantissas, so ``--resume`` restarts from a
binary sidecar instead (:func:`save_checkpoint` / :func:`load_checkpoint`,
``<solutions>.ckpt.npz``): the tile watermark, the full-precision
warm-start Jones, the divergence-reset state and the solutions file's
valid byte length. Its ``np.savez`` keys are the JAX package's, so a
sidecar written by either package resumes in the other.
"""

from __future__ import annotations

import json
import os

import numpy as np

def jones_to_columns(J: np.ndarray, nchunk: np.ndarray) -> np.ndarray:
    """[M, Kmax, N, 2, 2] complex -> [8N, Mt] real column block.

    Clusters are written in REVERSE order (M-1..0), chunks forward within a
    cluster, matching the reference writer/reader exactly
    (fullbatch_mode.cpp:586, readsky.c:711) so files interchange with it.
    """
    M, _, N = J.shape[:3]
    cols = []
    for m in range(M - 1, -1, -1):
        for k in range(int(nchunk[m])):
            col = np.empty(8 * N, J.real.dtype)
            Jm = J[m, k]                      # [N, 2, 2]
            col[0::8] = Jm[:, 0, 0].real
            col[1::8] = Jm[:, 0, 0].imag
            col[2::8] = Jm[:, 1, 0].real
            col[3::8] = Jm[:, 1, 0].imag
            col[4::8] = Jm[:, 0, 1].real
            col[5::8] = Jm[:, 0, 1].imag
            col[6::8] = Jm[:, 1, 1].real
            col[7::8] = Jm[:, 1, 1].imag
            cols.append(col)
    return np.stack(cols, axis=1)


def columns_to_jones(cols: np.ndarray, nchunk: np.ndarray) -> np.ndarray:
    """[8N, Mt] real columns -> padded [M, Kmax, N, 2, 2] complex."""
    n8, mt = cols.shape
    N = n8 // 8
    M = len(nchunk)
    kmax = int(np.max(nchunk))
    J = np.zeros((M, kmax, N, 2, 2), np.complex128)
    ci = 0
    for m in range(M - 1, -1, -1):
        for k in range(int(nchunk[m])):
            col = cols[:, ci]
            J[m, k, :, 0, 0] = col[0::8] + 1j * col[1::8]
            J[m, k, :, 1, 0] = col[2::8] + 1j * col[3::8]
            J[m, k, :, 0, 1] = col[4::8] + 1j * col[5::8]
            J[m, k, :, 1, 1] = col[6::8] + 1j * col[7::8]
            ci += 1
    # fill unused chunk slots with the last live chunk's Jones so padded
    # slots stay invertible and behave like the nearest real solution
    for m in range(M):
        for k in range(int(nchunk[m]), kmax):
            J[m, k] = J[m, nchunk[m] - 1]
    return J


class SolutionWriter:
    """Streaming writer: one header + an 8N-row block per solve interval."""

    def __init__(self, path: str, freq0_hz: float, bandwidth_hz: float,
                 interval_min: float, n_stations: int, n_clusters: int,
                 n_eff_clusters: int, nchan: int | None = None,
                 nsolbw: int | None = None):
        """With ``nchan``/``nsolbw`` set, writes the stochastic multi-band
        header variant (minibatch_mode.cpp:276-278): each row then holds
        the columns of every mini-band in turn (:500-514)."""
        self.f = open(path, "w")
        self.n_stations = n_stations
        self.f.write("# solution file (sagecal-tpu) commands:\n")
        if nsolbw is not None:
            self.f.write("# freq(MHz) bandwidth(MHz) channels mini-bands "
                         "time_interval(min) stations clusters "
                         "effective_clusters\n")
            self.f.write(f"{freq0_hz * 1e-6:f} {bandwidth_hz * 1e-6:f} "
                         f"{nchan} {nsolbw} {interval_min:f} {n_stations} "
                         f"{n_clusters} {n_eff_clusters}\n")
        else:
            self.f.write("# freq(MHz) bandwidth(MHz) time_interval(min) "
                         "stations clusters effective_clusters\n")
            self.f.write(f"{freq0_hz * 1e-6:f} {bandwidth_hz * 1e-6:f} "
                         f"{interval_min:f} {n_stations} {n_clusters} "
                         f"{n_eff_clusters}\n")

    @classmethod
    def open_resume(cls, path: str, n_stations: int) -> "SolutionWriter":
        """Reopen a solutions file for appending (``--resume``): its
        header and completed intervals are on disk, the file already
        truncated to the checkpoint's byte watermark."""
        w = cls.__new__(cls)
        w.f = open(path, "a")
        w.n_stations = n_stations
        return w

    def _write_cols(self, cols: np.ndarray) -> None:
        self.f.write("".join(
            f"{r} " + " ".join(f"{x:e}" for x in cols[r]) + "\n"
            for r in range(cols.shape[0])))
        self.f.flush()

    def write_interval(self, J: np.ndarray, nchunk: np.ndarray) -> None:
        self._write_cols(jones_to_columns(np.asarray(J), nchunk))

    def write_interval_multiband(self, J_bands, nchunk: np.ndarray) -> None:
        """One row block with the columns of each mini-band in turn
        (minibatch_mode.cpp:500-514)."""
        self._write_cols(np.hstack([jones_to_columns(np.asarray(J), nchunk)
                                    for J in J_bands]))

    def close(self):
        self.f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()


def read_solutions(path: str, nchunk: np.ndarray):
    """Read a solution file -> (header dict, list of [M, Kmax, N, 2, 2]).

    Reference ``read_solutions`` readsky.c:681; one entry per interval.
    """
    header = None
    blocks = []
    rows = []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            tok = line.split()
            if header is None:
                if len(tok) >= 8:   # stochastic multi-band header variant
                    header = {
                        "freq_mhz": float(tok[0]),
                        "bandwidth_mhz": float(tok[1]),
                        "nchan": int(tok[2]), "nsolbw": int(tok[3]),
                        "interval_min": float(tok[4]),
                        "n_stations": int(tok[5]), "n_clusters": int(tok[6]),
                        "n_eff_clusters": int(tok[7]),
                    }
                else:
                    header = {
                        "freq_mhz": float(tok[0]),
                        "bandwidth_mhz": float(tok[1]),
                        "interval_min": float(tok[2]),
                        "n_stations": int(tok[3]), "n_clusters": int(tok[4]),
                        "n_eff_clusters": int(tok[5]), "nsolbw": 1,
                    }
                n8 = 8 * header["n_stations"]
                continue
            rows.append([float(x) for x in tok[1:]])
            if len(rows) == n8:
                cols = np.asarray(rows).reshape(n8, -1)
                nb = header.get("nsolbw", 1)
                if nb > 1:
                    mt = cols.shape[1] // nb
                    blocks.append([columns_to_jones(
                        cols[:, b * mt:(b + 1) * mt], nchunk)
                        for b in range(nb)])
                else:
                    blocks.append(columns_to_jones(cols, nchunk))
                rows = []
    if rows:
        # fail loudly on a truncated interval, like the reference reader's
        # EOF warning (readsky.c:733) — resuming from a half-written
        # checkpoint must not silently drop state
        raise ValueError(
            f"solution file {path!r} ends mid-interval "
            f"({len(rows)}/{n8} rows); truncated checkpoint?")
    return header, blocks


def read_warm_start(path: str, sky, n_stations: int):
    """``-q`` warm start (``solutions.read_warm_start``; main.cpp -q: "the
    same format as a solution file, only solutions for 1 timeslot
    needed"): the last interval of the file, [M, Kmax, N, 2, 2] complex,
    or None for a file with no interval; band 0 of a stochastic
    multi-band file. Raises ``ValueError`` when the file's station count
    or effective-cluster count differs from the run's (a ``-p``
    consensus Z file has n_eff_clusters x npoly columns and would
    otherwise be misread as Jones columns)."""
    header, blocks = read_solutions(path, sky.nchunk)
    if not blocks:
        return None
    if header["n_stations"] != n_stations:
        raise ValueError(
            f"-q {path}: solution file is for {header['n_stations']} "
            f"stations, run has {n_stations}")
    if header["n_eff_clusters"] != sky.n_eff_clusters:
        raise ValueError(
            f"-q {path}: solution file has {header['n_eff_clusters']} "
            f"effective clusters, run has {sky.n_eff_clusters} (a -p "
            f"consensus Z file has n_eff_clusters x npoly columns and "
            f"cannot seed -q; use a worker/J solution file)")
    last = blocks[-1]
    return last[0] if isinstance(last, list) else last


# ---------------------------------------------------------------------------
# tile-boundary checkpoint sidecar (--resume)
# ---------------------------------------------------------------------------

def checkpoint_path(solution_path: str) -> str:
    """The binary checkpoint sidecar beside a solutions file."""
    return solution_path + ".ckpt.npz"


def save_checkpoint(path: str, *, tile: int, J: np.ndarray, first: bool,
                    res_prev: float | None, inflight: int,
                    sol_bytes: int, meta: dict) -> None:
    """One tile boundary's resumable state, written then renamed (a kill
    between checkpoints loses whole tiles, never corrupts one). Written
    after the tile's solution and residual writes. ``J`` is the
    full-precision warm-start chain, ``sol_bytes`` the solutions file's
    valid length at the watermark, ``meta`` the run's identity."""
    tmp = path + ".tmp.npz"
    np.savez(tmp, J=np.asarray(J, np.complex128), tile=int(tile),
             first=int(bool(first)),
             res_prev=np.float64(np.nan if res_prev is None else res_prev),
             inflight=int(inflight), sol_bytes=int(sol_bytes),
             meta=json.dumps(meta, sort_keys=True))
    os.replace(tmp, path)


def load_checkpoint(path: str, expect_meta: dict | None = None):
    """A checkpoint sidecar -> its state dict, or None when absent. Every
    key of ``expect_meta`` must match the stored run identity, else
    ``ValueError`` (a checkpoint of a different run)."""
    if not os.path.exists(path):
        return None
    with np.load(path) as z:
        meta = json.loads(str(z["meta"]))
        if expect_meta is not None:
            for k, v in expect_meta.items():
                if meta.get(k) != v:
                    raise ValueError(
                        f"checkpoint {path!r} was written by a "
                        f"different run: {k}={meta.get(k)!r} vs "
                        f"expected {v!r}")
        rp = float(z["res_prev"])
        return dict(tile=int(z["tile"]), J=np.array(z["J"]),
                    first=bool(int(z["first"])),
                    res_prev=None if np.isnan(rp) else rp,
                    inflight=int(z["inflight"]),
                    sol_bytes=int(z["sol_bytes"]), meta=meta)
