"""One subband's rows over ranks (port of ``sagecal_tpu/parallel.py``:
``--shard-baselines``).

The reference splits each subband's ``Nbase * tilesz`` rows over threads
for every predict, cost, gradient and Jacobian (``predict.c:417-495``).
The JAX package runs that split over a device mesh: the solve is jitted
with its row-indexed inputs sharded over a "base" axis, the rows padded
to the mesh with zero-weight rows (``pad_rows``), and GSPMD places the
all-reduces (``sharded_sagefit``). Here the ranks are processes of
``torch.distributed`` (``distributed.py``) and every all-reduce is placed
by hand:

- :class:`RowPlan` shards by whole timeslots: rank r holds the
  contiguous block of ``ceil(tilesz / P)`` timeslots from ``r ceil(tilesz
  / P)``, the last block padded with whole zero-weight timeslots (the
  JAX ``pad_rows`` contract at a coarser grain). Each shard keeps the
  [t, nbase] period, so the fused sweep and the matvec kernel stay the
  route on every shard (``lm.use_sweep(..., row_period=nbase, ...)``);
  the JAX package gives that route up under GSPMD (``nbase=0``), whose
  row padding breaks the period. Per-row tables (chunk ids, timeslots,
  ordered-subset ids) are made for the whole tile and sliced, so every
  subset holds the rows it holds in the unsharded run.
- :class:`RowGroup` is a joined group (``distributed.Group``) and the
  plan; the solvers carry it in their configs (``SageConfig.rows``,
  ``lm.LMConfig.rows``, ``rtr.RTRConfig.rows``, ``rtr.NSDConfig.rows``)
  as the consensus runner carries its group.
- :func:`row_sum` is the one collective that every row contraction goes
  through (``distributed.all_reduce_sum`` plus plain-integer counters of
  collectives and bytes, by site); :func:`row_sums` sums several tensors
  in one collective. Without a group both are the identity. Every host
  decision of the solvers reads only such sums, so every rank takes the
  same branch and meets its peers at the same collectives; the
  replicated work after a sum is deterministic, so J comes back the same
  bits on every rank.
- :func:`run_sharded` starts the ranks of one run on this host
  (``distributed.spawn``, a free port), the CLI's launcher.

The padded rows weigh nothing in any sum, and the residual norms divide
by the real row count (:attr:`RowPlan.n_rows`): ``res_0`` and ``res_1``
do not depend on P. The JAX package's sharded path divides by the padded
count (ROADMAP C15).
"""

from __future__ import annotations

import dataclasses
import time
from typing import NamedTuple

import numpy as np
import torch

from sagecal_tpu_torch import distributed as dist

#: row-sum collectives, their bytes and their host seconds (each from
#: the call to the result on this rank's device, waiting for the peers
#: included) since the last :func:`reset_counters`, and the collectives
#: by site (the solver contraction that made them)
COLLECTIVES = 0
BYTES = 0
SECONDS = 0.0
SITES: dict = {}


def reset_counters() -> None:
    global COLLECTIVES, BYTES, SECONDS
    COLLECTIVES = 0
    BYTES = 0
    SECONDS = 0.0
    SITES.clear()


def counters() -> dict:
    """The row-sum counters as a record: collectives, bytes, seconds, by
    site."""
    return {"collectives": COLLECTIVES, "bytes": BYTES, "seconds": SECONDS,
            "sites": dict(SITES)}


def counters_since(before: dict) -> dict:
    """The row sums made since ``before`` (a :func:`counters` record),
    as such a record."""
    now = counters()
    return {"collectives": now["collectives"] - before["collectives"],
            "bytes": now["bytes"] - before["bytes"],
            "seconds": now["seconds"] - before["seconds"],
            "sites": {k: n - before["sites"].get(k, 0)
                      for k, n in now["sites"].items()
                      if n > before["sites"].get(k, 0)}}


class RowPlan(NamedTuple):
    """Whole-timeslot blocks of one tile's [tilesz, nbase] rows over
    ``world`` ranks."""

    tilesz: int
    nbase: int
    world: int

    @property
    def tper(self) -> int:
        """Timeslots a rank holds, padding included."""
        return -(-int(self.tilesz) // int(self.world))

    @property
    def n_rows(self) -> int:
        """The tile's real rows (what the residual norms divide by)."""
        return int(self.tilesz) * int(self.nbase)

    @property
    def rows_per_rank(self) -> int:
        return self.tper * int(self.nbase)

    def block(self, rank: int) -> tuple:
        """Rank ``rank``'s real timeslots [t0, t1) (t1 <= tilesz; empty
        for a rank of padding alone)."""
        t0 = min(int(rank) * self.tper, int(self.tilesz))
        return t0, min(t0 + self.tper, int(self.tilesz))

    def blocks(self) -> list:
        return [self.block(r) for r in range(int(self.world))]

    def take(self, a, rank: int, fill=0):
        """Rank ``rank``'s rows of ``a`` (numpy, rows on axis 0), padded
        with ``fill`` to :attr:`rows_per_rank`."""
        a = np.asarray(a)
        t0, t1 = self.block(rank)
        nb = int(self.nbase)
        part = a[t0 * nb:t1 * nb]
        pad = self.rows_per_rank - part.shape[0]
        if not pad:
            return part
        return np.concatenate(
            [part, np.full((pad,) + a.shape[1:], fill, a.dtype)])

    def take_cols(self, a, rank: int, fill=0):
        """:meth:`take` along the last axis ([M, B] chunk ids)."""
        return np.moveaxis(self.take(np.moveaxis(np.asarray(a), -1, 0),
                                     rank, fill), 0, -1)

    def local_tile(self, tile, rank: int):
        """Rank ``rank``'s rows of a ``VisTile``: its timeslot block, the
        padded timeslots flagged (weight 0), zero data and uvw, on the
        baseline pattern (the sweep's [t, nbase] period); the tile's time
        table stays whole (row timeslots are global)."""
        if tile.nrows != self.n_rows:
            raise ValueError(f"row plan of {self.n_rows} rows, tile of "
                             f"{tile.nrows}")
        nb = int(self.nbase)
        pattern = {k: np.tile(np.asarray(getattr(tile, k))[:nb], self.tper)
                   for k in ("sta1", "sta2")}
        return dataclasses.replace(
            tile, u=self.take(tile.u, rank), v=self.take(tile.v, rank),
            w=self.take(tile.w, rank), x=self.take(tile.x, rank),
            flags=self.take(tile.flags, rank, fill=1), **pattern,
            cflags=None if tile.cflags is None
            else self.take(tile.cflags, rank, fill=1))


class RowGroup(NamedTuple):
    """A joined group (``distributed.Group``) and its :class:`RowPlan`:
    this rank holds ``plan.block(group.rank)``."""

    group: dist.Group
    plan: RowPlan

    @property
    def rank(self) -> int:
        return self.group.rank

    @property
    def world(self) -> int:
        return self.group.world

    @property
    def n_rows(self) -> int:
        return self.plan.n_rows


def row_sum(t: torch.Tensor, rows: RowGroup | None,
            site: str = "row") -> torch.Tensor:
    """The sum of ``t`` over the ranks of ``rows`` (``t`` itself without
    a group), counted under ``site``. Keep it out of an autograd graph:
    sum each rank's value or gradient after it is formed."""
    global COLLECTIVES, BYTES, SECONDS
    if rows is None:
        return t
    COLLECTIVES += 1
    BYTES += t.numel() * t.element_size()
    SITES[site] = SITES.get(site, 0) + 1
    t0 = time.perf_counter()
    out = dist.all_reduce_sum(t.detach(), rows.group)
    SECONDS += time.perf_counter() - t0
    return out


def row_sums(tensors, rows: RowGroup | None, site: str = "row",
             live=None) -> tuple:
    """:func:`row_sum` of several tensors of one dtype in one collective;
    returns them in order and shape (as they are without a group).
    ``live`` (indices on the leading axis, the same on every rank) sums
    only those entries and returns 0 for the others: for entries that
    are 0 on every rank (a padded hybrid chunk, which holds no row)."""
    tensors = tuple(tensors)
    if rows is None:
        return tensors
    parts = tensors if live is None else tuple(t.index_select(0, live)
                                               for t in tensors)
    flat = row_sum(torch.cat([t.reshape(-1) for t in parts]), rows, site)
    out, o = [], 0
    for t, part in zip(tensors, parts):
        got = flat[o:o + part.numel()].view(part.shape)
        o += part.numel()
        out.append(got if live is None
                   else t.new_zeros(t.shape).index_copy_(0, live, got))
    return tuple(out)


def _rank_main(rank, argv, world, port, echo):
    """One rank of :func:`run_sharded`: the CLI's configuration from
    ``argv`` (``cli.prepare``), the group at ``127.0.0.1:port``, the
    pipeline over it (``pipeline.run``). Returns (records, log lines);
    rank 0 also prints its lines when ``echo``."""
    from sagecal_tpu_torch import cli
    from sagecal_tpu_torch import device as devmod
    from sagecal_tpu_torch import pipeline
    cfg, device = cli.prepare(argv)
    lines: list = []

    def log(s):
        lines.append(s)
        if echo:
            print(s, flush=True)

    dev = devmod.resolve(device, index=rank)
    group = dist.init(f"127.0.0.1:{port}", world, rank, dev)
    try:
        return pipeline.run(cfg, device=dev, log=log, group=group), lines
    finally:
        dist.shutdown(group)


def run_sharded(argv, world: int, timeout: float = 900.0,
                echo: bool = False) -> list:
    """Run the full-batch CLI's command line ``argv`` with one subband's
    rows over ``world`` ranks on this host (``distributed.spawn`` on a
    free port; each rank at ``distributed.RANK_THREADS`` torch threads,
    rank r on card ``r % device_count`` or the CPU under ``--platform
    cpu``). Only rank 0 logs and writes. Returns per rank, in rank order,
    (the pipeline's records, its log lines); ``echo`` prints rank 0's
    lines as they come."""
    return dist.spawn(_rank_main, int(world),
                      (list(argv), int(world), dist.free_port(), echo),
                      timeout)
