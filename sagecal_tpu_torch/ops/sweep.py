"""Fused LM sweep: kernel 2 of the port (counterpart of
``sagecal_tpu/ops/sweep_pallas.py``), plus the PyTorch ops around it.

:func:`sweep_blocks` replaces the Pallas kernel ``_sweep_kernel``
(``sweep_pallas.py:395``, maths in ``_sweep_body`` ``:171``, launched by
``sweep_blocks`` ``:482``): one pass over a cluster visit's rows per
hybrid chunk, giving per-baseline Gram blocks, gradients and the
acceptance cost. On a CUDA tensor it launches the hand-written kernel
in ``csrc/sweep.cu`` (full Jones, float32) or raises; on a CPU tensor it
runs the plain PyTorch version :func:`sweep_blocks_plain` (``_sweep_body``
over [T, nb] tensors plus the time sum) in the tensors' dtype.

What bounds the kernel on the card is bytes: 33 words a row (x, w, cw,
coherency, chunk id), each row read by its own chunk only, against
:data:`SWEEP_FLOPS_PER_ROW` float32 operations; the design notes are in
``csrc/sweep.cu``.

Around the kernel, as torch ops: the per-baseline Jones gathers,
:func:`_station_aggregates` (``index_add_``, repeated stations
accumulate), :func:`gn_blocks`, :func:`normal_equations_fused`,
:func:`_assemble_damped`, :func:`chol_solve_blocks_shift` and
:func:`solve_damped_blocks` with its single boosted-jitter retry
(batched ``torch.linalg`` Cholesky; XLA in the JAX package, not Pallas).

:func:`gn_matvec_blocks` replaces the second Pallas kernel of the file,
``_matvec_kernel`` (``sweep_pallas.py:946``, launched by
``_matvec_blocks_jit`` ``:988``): y = (JTJ + shift I) v straight from
the Gram blocks, the product behind every ``--inner cg`` PCG and tCG
trip. On a CUDA tensor it launches ``csrc/matvec.cu`` or raises; on a
CPU tensor it runs :func:`gn_matvec_blocks_plain` (gather, einsum,
``index_add_``).

:func:`sweep_blocks_visits` replaces the third, ``_visits_kernel``
(``sweep_pallas.py:439``, launched by ``sweep_blocks_visits`` ``:582``;
the JAX package reaches it only under ``jax.vmap``, through the
``custom_vmap`` rule of ``_sweep_vmappable`` ``:719``): the same pass for
V cluster visits in one launch, each operand either per visit or shared
by all. On a CUDA tensor it launches the second entry point of
``csrc/sweep.cu`` or raises; on a CPU tensor it runs
:func:`sweep_blocks_visits_plain`. The solvers reach it through
:class:`Lanes`, the layout of an in-flight cluster group
(``solvers/sage.py``): V visits folded into the row and chunk axes, so
everything after the sweep sees V K chunks. It is bound by bytes like the
single-visit sweep; a shared operand is read once from memory and served
to the other visits from L2 (notes in ``csrc/sweep.cu``).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from sagecal_tpu_torch.ops import cuda_lib

#: float32 operations per row visit for one chunk, counted from the
#: kernel body: A = C Jq^H, Bm = Jp C, V = Jp A (56 each), residual,
#: squared weights and weighted residual (24), acceptance cost (24),
#: the symmetric pp/qq blocks (2 x 20 sums x 4 terms x 3), the pq block
#: (64 x 2 x 3), the gradients (16 x 4 x 2)
SWEEP_FLOPS_PER_ROW = 168 + 48 + 240 + 240 + 384 + 128
#: hybrid-chunk cap, as in the JAX package
MAX_CHUNKS = 4
#: distinct sums per (chunk, baseline) in the kernel, and the caller
#: layout's element count (pp 32, qq 32, pq 64, jtep 8, jteq 8, cost 1)
N_ACC = 121
N_OUT = 145
#: threads the wrapper aims to have in flight when it splits the time
#: axis (132 SMs x 256 resident threads at the kernel's register use)
TARGET_THREADS = 132 * 256

#: float32 operations per (chunk, baseline) of one blocks matvec: 192
#: multiply-adds (pp and qq 16 each per side, pq 64 each way)
MATVEC_FLOPS_PER_BASELINE = 2 * 192

#: kernel launches since the last reset (the plain versions never count):
#: the sweep kernel, the matvec kernel and the multi-visit sweep kernel
LAUNCHES = 0
MATVEC_LAUNCHES = 0
VISITS_LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES, MATVEC_LAUNCHES, VISITS_LAUNCHES
    LAUNCHES = 0
    MATVEC_LAUNCHES = 0
    VISITS_LAUNCHES = 0


def supported(kmax: int, row_period: int, B: int) -> bool:
    """True when the fused sweep applies: baseline-major [tilesz, nbase]
    rows and a bounded hybrid-chunk count."""
    return (1 <= kmax <= MAX_CHUNKS and row_period > 0
            and B % row_period == 0)


class GNBlocks(NamedTuple):
    """Per-(chunk, baseline) Gram blocks of the Gauss-Newton operator.

    pp, qq [K, nb, 2, 4, 4]; pq [K, nb, 2, 2, 4, 4]; D [K, N, 2, 4, 4]
    the station-aggregated diagonal blocks."""

    pp: torch.Tensor
    qq: torch.Tensor
    pq: torch.Tensor
    D: torch.Tensor


def _factors(A, Bm):
    """Wirtinger factors fa [..., o, ri, 4], fb [..., a, ri, 4]
    (normal_eq._ma_factor / _mb_factor) of A = C Jq^H and Bm = Jp C."""
    Ar = A.real.transpose(-1, -2)                    # [..., o, d]
    Ai = A.imag.transpose(-1, -2)
    fa = torch.stack([torch.stack([Ar, -Ai], -1),
                      torch.stack([Ai, Ar], -1)], -3)
    Br, Bi = Bm.real, Bm.imag                        # [..., a, d]
    fb = torch.stack([torch.stack([Br, Bi], -1),
                      torch.stack([Bi, -Br], -1)], -3)
    shp = A.shape[:-2] + (2, 2, 4)
    return fa.reshape(shp), fb.reshape(shp)


def sweep_blocks_plain(x8, Jp, Jq, coh, chunk_id, wt, cost_wt, nb: int):
    """Plain PyTorch version of the fused sweep.

    x8/wt/cost_wt [B, 8] real; Jp/Jq [K, nb, 2, 2] complex (per-baseline
    Jones of each chunk); coh [B, 2, 2] complex; chunk_id [B]. Returns
    (pp, qq, pq, jtep, jteq, cost) in the caller layouts [K, nb, ...]
    and cost [K]."""
    K = Jp.shape[0]
    T = x8.shape[0] // nb
    x = x8.reshape(T, nb, 8)
    C = coh.reshape(T, nb, 2, 2)
    cid = chunk_id.reshape(T, nb)
    outs = []
    for k in range(K):
        mk = (cid == k).to(x.dtype)[..., None] if K > 1 else 1.0
        w = wt.reshape(T, nb, 8) * mk
        cw = cost_wt.reshape(T, nb, 8) * mk
        A = C @ Jq[k].conj().transpose(-1, -2)       # [T, nb, 2, 2]
        Bm = Jp[k] @ C
        V = Jp[k] @ A
        r = x - torch.view_as_real(V.reshape(T, nb, 4)).reshape(T, nb, 8)
        fa, fb = _factors(A, Bm)                     # [T, nb, 2, 2, 4]
        w2 = (w * w).reshape(T, nb, 2, 2, 2)         # [T, nb, a, o, ri]
        rw2 = (r.reshape(T, nb, 2, 2, 2)) * w2
        pp = torch.einsum("tbaor,tbori,tborj->baij", w2, fa, fa)
        qq = torch.einsum("tbaor,tbari,tbarj->boij", w2, fb, fb)
        pq = torch.einsum("tbaor,tbori,tbarj->baoij", w2, fa, fb)
        jtep = torch.einsum("tbaor,tbori->bai", rw2, fa)
        jteq = torch.einsum("tbaor,tbari->boi", rw2, fb)
        cost = ((r * cw) ** 2).sum()
        outs.append((pp, qq, pq, jtep, jteq, cost))
    return tuple(torch.stack([o[i] for o in outs]) for i in range(6))


def _time_slices(T: int, nb: int, K: int):
    """(slice count, rows per slice) so that about TARGET_THREADS
    (chunk, baseline, slice) threads are in flight (K counts every
    visit's chunks in the multi-visit sweep)."""
    want = max(1, -(-TARGET_THREADS // max(K * nb, 1)))
    tl = -(-T // min(T, want))
    return -(-T // tl), tl


def _sweep_cuda(x8, Jp, Jq, coh, chunk_id, wt, cost_wt, nb: int):
    global LAUNCHES
    dev = x8.device
    for name, a in (("x8", x8), ("wt", wt), ("cost_wt", cost_wt)):
        if a.dtype != torch.float32 or a.device != dev:
            raise TypeError(f"sweep kernel: {name} must be float32 on {dev} "
                            f"(got {a.dtype} on {a.device}); reduced "
                            "storage policies are ROADMAP queue A item 9")
    if coh.dtype != torch.complex64 or Jp.dtype != torch.complex64:
        raise TypeError("sweep kernel: coherencies and Jones must be "
                        "complex64")
    K = Jp.shape[0]
    B = x8.shape[0]
    T = B // nb
    x8, wt, cost_wt = x8.contiguous(), wt.contiguous(), cost_wt.contiguous()
    cohr = torch.view_as_real(coh.resolve_conj().contiguous())
    jpr = torch.view_as_real(Jp.resolve_conj().contiguous())
    jqr = torch.view_as_real(Jq.resolve_conj().contiguous())
    cid = chunk_id.to(device=dev, dtype=torch.int32).contiguous()
    nsl, tl = _time_slices(T, nb, K)
    part = torch.empty((nsl, K, N_ACC, nb), dtype=torch.float32, device=dev)
    out = torch.empty((K, nb, N_OUT), dtype=torch.float32, device=dev)
    lib = cuda_lib.load("sweep")
    stream = cuda_lib.stream_ptr(dev)
    cuda_lib.check(lib.sweep_partials_launch(
        x8.data_ptr(), wt.data_ptr(), cost_wt.data_ptr(), cid.data_ptr(),
        cohr.data_ptr(), jpr.data_ptr(), jqr.data_ptr(), part.data_ptr(),
        T, nb, K, nsl, tl, stream), "sweep_partials_kernel")
    cuda_lib.check(lib.sweep_reduce_launch(
        part.data_ptr(), out.data_ptr(), nb, K, nsl, stream),
        "sweep_reduce_kernel")
    LAUNCHES += 1
    pp = out[..., 0:32].view(K, nb, 2, 4, 4)
    qq = out[..., 32:64].view(K, nb, 2, 4, 4)
    pq = out[..., 64:128].view(K, nb, 2, 2, 4, 4)
    jtep = out[..., 128:136].view(K, nb, 2, 4)
    jteq = out[..., 136:144].view(K, nb, 2, 4)
    return pp, qq, pq, jtep, jteq, out[..., 144].sum(dim=-1)


def sweep_blocks(x8, J, coh, sta1, sta2, chunk_id, wt, cost_wt,
                 row_period: int, kmax: int, jones: str = "full"):
    """The fused cluster-visit pass (``sweep_pallas.sweep_blocks``).

    x8/wt/cost_wt [B, 8] real; J [K, N, 2, 2] complex; coh [B, 2, 2];
    sta1/sta2/chunk_id [B] (baseline-periodic: only the first
    ``row_period`` stations are used). Returns (pp [K, nb, 2, 4, 4],
    qq [K, nb, 2, 4, 4], pq [K, nb, 2, 2, 4, 4], jtep [K, nb, 2, 4],
    jteq [K, nb, 2, 4], cost [K])."""
    if jones != "full":
        raise NotImplementedError(
            f"--jones {jones} (md < 4) is not ported yet (ROADMAP queue A "
            "item 9: constrained Jones modes)")
    nb = int(row_period)
    K = int(kmax)
    if J.shape[0] != K or x8.shape[0] % nb:
        raise ValueError(f"sweep_blocks: J has {J.shape[0]} chunks for "
                         f"kmax={K}, or {x8.shape[0]} rows are not a "
                         f"multiple of row_period={nb}")
    s1b = sta1[:nb].long()
    s2b = sta2[:nb].long()
    Jp = J[:, s1b]                                   # [K, nb, 2, 2]
    Jq = J[:, s2b]
    if x8.device.type == "cuda":
        return _sweep_cuda(x8, Jp, Jq, coh, chunk_id, wt, cost_wt, nb)
    return sweep_blocks_plain(x8, Jp, Jq, coh, chunk_id, wt, cost_wt, nb)


class Lanes(NamedTuple):
    """V cluster visits solved as one problem (an in-flight group of
    ``solvers/sage.py``), folded into the axes the solvers batch over:
    rows [V B] with visit v's rows at v B .. (v + 1) B, chunks [V K] with
    visit v's chunk k at v K + k (its chunk ids offset by v K). A per-row
    operand that every visit shares stays [B, ...]. ``cid`` holds the
    visits' own chunk ids (0 .. K - 1, int32) for the sweep: [B] when all
    visits have the same, else [V, B]."""

    V: int
    K: int
    cid: torch.Tensor

    @property
    def B(self) -> int:
        return self.cid.shape[-1]

    def shared(self, t) -> bool:
        """True when the per-row tensor ``t`` is one [B, ...] array for all
        visits."""
        return self.V > 1 and t.shape[0] == self.B

    def rows(self, t):
        """``t`` in the folded [V B, ...] layout (a shared one repeated)."""
        if self.shared(t):
            return t.repeat((self.V,) + (1,) * (t.dim() - 1))
        return t

    def visits(self, t):
        """A folded per-row tensor as a [V, B, ...] view; a shared one as
        it is."""
        if self.shared(t):
            return t
        return t.view((self.V, self.B) + tuple(t.shape[1:]))

    def per_row(self, s):
        """Per-visit values [V] as a [V B, 1] column."""
        return s.repeat_interleave(self.B)[:, None]


def sweep_blocks_visits_plain(x8, Jp, Jq, coh, chunk_id, wt, cost_wt,
                              nb: int, vsize: int):
    """Plain PyTorch version of the multi-visit sweep: each operand
    carries a leading [V] axis or is one array shared by all V visits
    (x8/wt/cost_wt [(V,) B, 8], Jp/Jq [(V,) K, nb, 2, 2], coh [(V,) B, 2,
    2], chunk_id [(V,) B]). Returns the :func:`sweep_blocks_plain` tuple
    with a leading [V] on every output."""
    def pick(a, ndim, v):
        return a[v] if a.dim() == ndim + 1 else a

    outs = [sweep_blocks_plain(pick(x8, 2, v), pick(Jp, 4, v),
                               pick(Jq, 4, v), pick(coh, 3, v),
                               pick(chunk_id, 1, v), pick(wt, 2, v),
                               pick(cost_wt, 2, v), nb)
            for v in range(int(vsize))]
    return tuple(torch.stack([o[i] for o in outs]) for i in range(6))


def _visits_cuda(x8, Jp, Jq, coh, chunk_id, wt, cost_wt, nb: int, V: int,
                 K: int):
    global VISITS_LAUNCHES
    dev = Jp.device
    for name, a in (("x8", x8), ("wt", wt), ("cost_wt", cost_wt)):
        if a.dtype != torch.float32 or a.device != dev:
            raise TypeError(f"visits kernel: {name} must be float32 on {dev} "
                            f"(got {a.dtype} on {a.device}); reduced "
                            "storage policies are ROADMAP queue A item 9")
    if coh.dtype != torch.complex64 or Jp.dtype != torch.complex64 \
            or coh.device != dev:
        raise TypeError("visits kernel: coherencies and Jones must be "
                        f"complex64 on {dev}")
    B = x8.shape[-2]
    T = B // nb

    def arg(a, ndim):
        """(contiguous tensor, elements between visits: 0 when shared)."""
        a = a.contiguous()
        return a, (a[0].numel() if a.dim() == ndim + 1 else 0)

    x8, sx = arg(x8, 2)
    wt, sw = arg(wt, 2)
    cost_wt, scw = arg(cost_wt, 2)
    cohr, scoh = arg(torch.view_as_real(coh.resolve_conj()), 4)
    jpr, sj = arg(torch.view_as_real(Jp.resolve_conj()), 5)
    jqr, _ = arg(torch.view_as_real(Jq.resolve_conj()), 5)
    cid, scid = arg(chunk_id.to(device=dev, dtype=torch.int32), 1)
    nsl, tl = _time_slices(T, nb, V * K)
    part = torch.empty((nsl, V * K, N_ACC, nb), dtype=torch.float32,
                       device=dev)
    out = torch.empty((V * K, nb, N_OUT), dtype=torch.float32, device=dev)
    lib = cuda_lib.load("sweep")
    stream = cuda_lib.stream_ptr(dev)
    cuda_lib.check(lib.visits_partials_launch(
        x8.data_ptr(), wt.data_ptr(), cost_wt.data_ptr(), cid.data_ptr(),
        cohr.data_ptr(), jpr.data_ptr(), jqr.data_ptr(), part.data_ptr(),
        T, nb, K, V, nsl, tl, sx, sw, scw, scid, scoh, sj, stream),
        "visits_partials_kernel")
    cuda_lib.check(lib.sweep_reduce_launch(
        part.data_ptr(), out.data_ptr(), nb, V * K, nsl, stream),
        "sweep_reduce_kernel")
    VISITS_LAUNCHES += 1
    pp = out[..., 0:32].view(V, K, nb, 2, 4, 4)
    qq = out[..., 32:64].view(V, K, nb, 2, 4, 4)
    pq = out[..., 64:128].view(V, K, nb, 2, 2, 4, 4)
    jtep = out[..., 128:136].view(V, K, nb, 2, 4)
    jteq = out[..., 136:144].view(V, K, nb, 2, 4)
    return pp, qq, pq, jtep, jteq, out[..., 144].sum(dim=-1).view(V, K)


def sweep_blocks_visits(x8, J, coh, sta1, sta2, chunk_id, wt, cost_wt,
                        row_period: int, kmax: int, vsize: int,
                        jones: str = "full"):
    """V cluster visits in one pass (``sweep_pallas.sweep_blocks_visits``).

    Each of x8/wt/cost_wt [(V,) B, 8], J [(V,) K, N, 2, 2], coh [(V,) B,
    2, 2] and chunk_id [(V,) B] carries a leading [V] axis or is one
    array shared by every visit (the JAX package's static ``batched``
    6-tuple, read here off the ranks); sta1/sta2 are shared and
    baseline-periodic. Returns the :func:`sweep_blocks` tuple with a
    leading [V] axis on every output. On the card the outputs are views
    of one [V K, nb, 145] buffer, so the visits fold into the chunk axis
    without a copy."""
    if jones != "full":
        raise NotImplementedError(
            f"--jones {jones} (md < 4) is not ported yet (ROADMAP queue A "
            "item 9: constrained Jones modes)")
    nb, K, V = int(row_period), int(kmax), int(vsize)
    if J.shape[-4] != K or x8.shape[-2] % nb \
            or any(a.dim() == nd + 1 and a.shape[0] != V
                   for a, nd in ((x8, 2), (J, 4), (coh, 3), (chunk_id, 1),
                                 (wt, 2), (cost_wt, 2))):
        raise ValueError(f"sweep_blocks_visits: J has {J.shape[-4]} chunks "
                         f"for kmax={K}, rows are not a multiple of "
                         f"row_period={nb}, or a batched operand's visit "
                         f"axis is not {V}")
    s1b = sta1[:nb].long()
    s2b = sta2[:nb].long()
    Jp = J.index_select(-3, s1b)                     # [(V,) K, nb, 2, 2]
    Jq = J.index_select(-3, s2b)
    if J.device.type == "cuda":
        return _visits_cuda(x8, Jp, Jq, coh, chunk_id, wt, cost_wt, nb, V,
                            K)
    return sweep_blocks_visits_plain(x8, Jp, Jq, coh, chunk_id, wt, cost_wt,
                                     nb, V)


def _station_aggregates(pp, qq, jtep, jteq, s1b, s2b, N: int):
    """(D [K, N, 2, 4, 4], JTe [K, 8N]) from the per-baseline partials;
    ``index_add_`` accumulates repeated station indices."""
    K = pp.shape[0]
    md = pp.shape[-1]
    D = pp.new_zeros((K, N, 2, md, md))
    D.index_add_(1, s1b, pp).index_add_(1, s2b, qq)
    JTe = pp.new_zeros((K, N, 2, md))
    JTe.index_add_(1, s1b, jtep).index_add_(1, s2b, jteq)
    return D, JTe.reshape(K, 2 * md * N)


def gn_blocks(x8, J, coh, sta1, sta2, chunk_id, wt, n_stations: int,
              kmax: int, row_period: int, cost_wt=None,
              jones: str = "full", lanes: Lanes | None = None):
    """Operator assembly from one fused sweep: (GNBlocks, JTe [K, 8N],
    cost [K]) — ``sweep_pallas.gn_blocks``. With ``lanes`` the rows and
    chunks are a group's folded layout (K = V lanes.K), and one
    multi-visit sweep replaces the JAX package's vmapped sweep
    (``sweep_pallas._sweep_dispatch``)."""
    cw = wt if cost_wt is None else cost_wt
    if lanes is None:
        pp, qq, pq, jtep, jteq, cost = sweep_blocks(
            x8, J, coh, sta1, sta2, chunk_id, wt, cw, row_period, kmax,
            jones=jones)
    else:
        V, Kl = lanes.V, lanes.K
        outs = sweep_blocks_visits(
            lanes.visits(x8), J.view((V, Kl) + tuple(J.shape[1:])),
            lanes.visits(coh), sta1, sta2, lanes.cid, lanes.visits(wt),
            lanes.visits(cw), row_period, Kl, V, jones=jones)
        pp, qq, pq, jtep, jteq, cost = (
            o.reshape((V * Kl,) + tuple(o.shape[2:])) for o in outs)
    nb = int(row_period)
    s1b, s2b = sta1[:nb].long(), sta2[:nb].long()
    D, JTe = _station_aggregates(pp, qq, jtep, jteq, s1b, s2b, n_stations)
    return GNBlocks(pp=pp, qq=qq, pq=pq, D=D), JTe, cost


def _assemble_damped(fac: GNBlocks, shift, sta1, sta2, n_stations: int):
    """Dense [K, 8N, 8N] (damped) normal matrix from the blocks; the
    shift ([K] or None) folds into the station diagonals first."""
    K, nb = fac.pp.shape[0], fac.pp.shape[1]
    md = fac.pp.shape[-1]
    npar = 2 * md
    N = n_stations
    s1b, s2b = sta1[:nb].long(), sta2[:nb].long()
    D = fac.D
    if shift is not None:
        eyem = torch.eye(md, dtype=D.dtype, device=D.device)
        D = D + shift[:, None, None, None, None] * eyem
    eye2 = torch.eye(2, dtype=D.dtype, device=D.device)
    Dfull = torch.einsum("knaij,ab->knaibj", D, eye2).reshape(
        K, N, npar, npar)
    pq8 = fac.pq.permute(0, 1, 2, 4, 3, 5).reshape(K, nb, npar, npar)
    pq8T = fac.pq.permute(0, 1, 3, 5, 2, 4).reshape(K, nb, npar, npar)
    idx = torch.arange(N, device=D.device)
    G = D.new_zeros((K, N * N, npar, npar))
    G.index_add_(1, s1b * N + s2b, pq8)
    G.index_add_(1, s2b * N + s1b, pq8T)
    G.index_add_(1, idx * N + idx, Dfull)
    return G.view(K, N, N, npar, npar).permute(0, 1, 3, 2, 4).reshape(
        K, npar * N, npar * N)


def chol_solve_blocks_shift(fac: GNBlocks, JTe, shift, sta1, sta2,
                            n_stations: int):
    """One batched assemble + factor + solve of (JTJ + shift I) dp =
    JTe; returns (dp, ok) with ok = factorization succeeded and dp
    finite, per chunk."""
    A = _assemble_damped(fac, shift, sta1, sta2, n_stations)
    L, info = torch.linalg.cholesky_ex(A)
    dp = torch.cholesky_solve(JTe[..., None], L)[..., 0]
    return dp, (info == 0) & torch.isfinite(dp).all(dim=-1)


def solve_damped_blocks(fac: GNBlocks, JTe, mu, jitter, sta1, sta2,
                        n_stations: int):
    """Solve (JTJ + (mu + jitter) I) dp = JTe batched over chunks.

    A chunk whose factorization fails gets ONE retry with the shift
    boosted by 1e-3 * max|diag| (read from the D blocks); a chunk that
    fails again returns dp = 0. The retry is computed for every chunk
    and selected per chunk, so the call never waits on the device."""
    shift = mu + jitter
    dp, ok = chol_solve_blocks_shift(fac, JTe, shift, sta1, sta2,
                                     n_stations)
    dd = torch.diagonal(fac.D, dim1=-2, dim2=-1)
    diag_max = dd.reshape(dd.shape[0], -1).abs().amax(dim=-1)
    dp2, ok2 = chol_solve_blocks_shift(
        fac, JTe, shift + 1e-3 * torch.clamp(diag_max, min=1e-30), sta1,
        sta2, n_stations)
    zero = torch.zeros_like(dp)
    dpw = torch.where(ok[:, None], dp, torch.where(ok2[:, None], dp2, zero))
    return dpw, ok | ok2


def normal_equations_fused(x8, J, coh, sta1, sta2, chunk_id, wt,
                           n_stations: int, kmax: int, row_period: int,
                           cost_wt=None, jones: str = "full",
                           lanes: Lanes | None = None):
    """Dense (JTJ [K, 8N, 8N], JTe, cost) from one fused sweep
    (``sweep_pallas.normal_equations_fused``): the blocks expanded by
    :func:`_assemble_damped` without a shift."""
    fac, JTe, cost = gn_blocks(x8, J, coh, sta1, sta2, chunk_id, wt,
                               n_stations, kmax, row_period,
                               cost_wt=cost_wt, jones=jones, lanes=lanes)
    return _assemble_damped(fac, None, sta1, sta2, n_stations), JTe, cost


def gn_matvec_blocks_plain(fac: GNBlocks, v, s1b, s2b, n_stations: int,
                           shift=None):
    """Plain PyTorch version of the blocks matvec: v [K, 2 md N] gathered
    per baseline, the block products of ``_matvec_kernel`` as einsums,
    ``index_add_`` per station, then ``shift * v`` (shift [K] or a
    scalar)."""
    K, nb = fac.pp.shape[0], fac.pp.shape[1]
    md = fac.pp.shape[-1]
    vr = v.reshape(K, n_stations, 2, md)
    vp = vr[:, s1b]                                  # [K, nb, 2, md]
    vq = vr[:, s2b]
    yp = (torch.einsum("kbaij,kbaj->kbai", fac.pp, vp)
          + torch.einsum("kbaoij,kboj->kbai", fac.pq, vq))
    yq = (torch.einsum("kboji,kboi->kboj", fac.qq, vq)
          + torch.einsum("kbaoij,kbai->kboj", fac.pq, vp))
    y = v.new_zeros((K, n_stations, 2, md))
    y.index_add_(1, s1b, yp).index_add_(1, s2b, yq)
    y = y.reshape(K, 2 * md * n_stations)
    if shift is not None:
        y = y + torch.as_tensor(shift, dtype=y.dtype,
                                device=y.device)[..., None] * v
    return y


class StationLists(NamedTuple):
    """A tile's baseline layout as the matvec kernel reads it (int32):
    s1/s2 [nb] the baselines' stations; ``ent[ptr[n]:ptr[n + 1]]`` lists
    the (baseline b, side) entries of station n as 2 b + side, side 0
    where n = s1[b] and 1 where n = s2[b], in a fixed order."""

    s1: torch.Tensor
    s2: torch.Tensor
    ptr: torch.Tensor
    ent: torch.Tensor


def station_lists(sta1, sta2, nb: int, n_stations: int) -> StationLists:
    """The :class:`StationLists` of rows ``sta1``/``sta2`` (baseline
    period ``nb``), built on their device. ``sagefit_host`` builds them
    once per tile and hands them to every matvec of the tile."""
    s1b, s2b = sta1[:nb].long(), sta2[:nb].long()
    side = torch.cat([s1b, s2b])
    order = torch.sort(side, stable=True).indices   # e = side nb + b
    ent = (order % nb) * 2 + order // nb
    ptr = torch.zeros(n_stations + 1, dtype=torch.long, device=side.device)
    ptr[1:] = torch.cumsum(torch.bincount(side, minlength=n_stations), 0)
    return StationLists(*(t.to(torch.int32).contiguous()
                          for t in (s1b, s2b, ptr, ent)))


def _block_view(t, nb: int):
    """(tensor, words between consecutive baselines) with each baseline's
    block contiguous; a strided view of the sweep output is used as it
    is."""
    words = math.prod(t.shape[2:])
    st = t.stride()
    if t[0, 0].is_contiguous() and st[0] == nb * st[1] and st[1] >= words:
        return t, st[1]
    return t.contiguous(), words


def _matvec_cuda(fac: GNBlocks, v, lists: StationLists, n_stations: int,
                 shift):
    global MATVEC_LAUNCHES
    dev = v.device
    K, nb = fac.pp.shape[0], fac.pp.shape[1]
    md = fac.pp.shape[-1]
    if md != 4:
        raise NotImplementedError(
            "the matvec kernel is full Jones (md = 4); --jones diag|phase "
            "is ROADMAP queue A item 9")
    for name, a in (("pp", fac.pp), ("qq", fac.qq), ("pq", fac.pq),
                    ("v", v)):
        if a.dtype != torch.float32 or a.device != dev:
            raise TypeError(f"matvec kernel: {name} must be float32 on {dev} "
                            f"(got {a.dtype} on {a.device})")
    if v.shape != (K, 8 * n_stations):
        raise ValueError(f"matvec kernel: v has shape {tuple(v.shape)}, "
                         f"expected ({K}, {8 * n_stations})")
    pp, sp = _block_view(fac.pp, nb)
    qq, sq = _block_view(fac.qq, nb)
    pq, spq = _block_view(fac.pq, nb)
    v = v.contiguous()
    s1, s2, ptr, ent = lists
    if s1.shape[0] != nb or ptr.shape[0] != n_stations + 1 \
            or s1.device != dev:
        raise ValueError(f"matvec kernel: station lists for {s1.shape[0]} "
                         f"baselines and {ptr.shape[0] - 1} stations on "
                         f"{s1.device}, expected {nb} and {n_stations} on "
                         f"{dev}")
    sh = None
    if shift is not None:
        sh = torch.as_tensor(shift, device=dev).to(torch.float32)
        sh = sh.expand(K).contiguous()
    yb = torch.empty((K, nb, 16), dtype=torch.float32, device=dev)
    y = torch.empty((K, 8 * n_stations), dtype=torch.float32, device=dev)
    lib = cuda_lib.load("matvec")
    cuda_lib.check(lib.matvec_launch(
        pp.data_ptr(), qq.data_ptr(), pq.data_ptr(), sp, sq, spq,
        v.data_ptr(), s1.data_ptr(), s2.data_ptr(), ptr.data_ptr(),
        ent.data_ptr(), None if sh is None else sh.data_ptr(),
        yb.data_ptr(), y.data_ptr(), K, nb, n_stations,
        cuda_lib.stream_ptr(dev)), "matvec kernels")
    MATVEC_LAUNCHES += 1
    return y


def gn_matvec_blocks(fac: GNBlocks, v, sta1, sta2, n_stations: int,
                     shift=None, lists: StationLists | None = None):
    """(JTJ + shift I) @ v from the per-baseline Gram blocks
    (``sweep_pallas.gn_matvec_blocks``): v [K, 8N], shift [K] or None;
    sta1/sta2 the rows' station indices (baseline-periodic). On the card
    the kernel walks ``lists`` (:func:`station_lists` of the same rows),
    built for this call when not given."""
    nb = fac.pp.shape[1]
    if v.device.type == "cuda":
        if lists is None:
            lists = station_lists(sta1, sta2, nb, n_stations)
        return _matvec_cuda(fac, v, lists, n_stations, shift)
    return gn_matvec_blocks_plain(fac, v, sta1[:nb].long(),
                                  sta2[:nb].long(), n_stations, shift)
