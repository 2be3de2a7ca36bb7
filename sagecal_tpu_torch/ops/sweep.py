"""Fused LM sweep: kernel 2 of the port (counterpart of
``sagecal_tpu/ops/sweep_pallas.py``), plus the PyTorch ops around it.

:func:`sweep_blocks` replaces the Pallas kernel ``_sweep_kernel``
(``sweep_pallas.py:395``, maths in ``_sweep_body`` ``:171``, launched by
``sweep_blocks`` ``:482``): one pass over a cluster visit's rows per
hybrid chunk, giving per-baseline Gram blocks, gradients and the
acceptance cost. On a CUDA tensor it launches the hand-written kernel
in ``csrc/sweep.cu`` or raises; on a CPU tensor it runs the plain
PyTorch version :func:`sweep_blocks_plain` (``_sweep_body`` over [T, nb]
tensors plus the time sum) in the tensors' dtype. The rows (x8, wt,
cost_wt) arrive in the storage dtype of ``--dtype-policy``: float32 (the
pipeline's dtype on the CPU) or bf16/f16, whose instances widen the rows
at the load, round the model and factor planes through the storage
dtype where the JAX kernel's ``q()`` does and sum in float32. Both take the
Jones mode (``jones``: full, diag, phase), whose block width md = 4, 2, 1
sets the blocks' trailing dimensions, the kernel's instantiation and its
records (:data:`REC_WORDS`); J is constrained to the mode on entry (the
kernel zeroes the off-diagonals it reads itself).

What bounds the kernel on the card is bytes: 33 words a row (x, w, cw,
coherency, chunk id; 21 when x, w and cw are bf16 or f16), each row read
once and added to its own chunk's sums, against :func:`sweep_flops_per_row` float32 operations. It is one
launch (thread block clusters over time, the Jones gathered inside, the
per-chunk cost summed inside) for one visit or V, whose launch geometry
is the plain function :func:`sweep_geometry`; it writes block records of
:data:`REC_WORDS` words that the callers see as strided views
(:func:`record_views`). The design notes are in ``csrc/sweep.cu``.

Around the kernel, as torch ops: :func:`_station_aggregates`
(``index_add_``, repeated stations
accumulate), :func:`gn_blocks`, :func:`normal_equations_fused`,
:func:`_assemble_damped`, :func:`chol_solve_blocks_shift` and
:func:`solve_damped_blocks` with its single boosted-jitter retry
(:func:`shifted_solve`, :func:`retry_damped`: batched ``torch.linalg``
Cholesky, or LU under a reduced policy; XLA in the JAX package, not
Pallas).

:func:`gn_matvec_blocks` replaces the second Pallas kernel of the file,
``_matvec_kernel`` (``sweep_pallas.py:946``, launched by
``_matvec_blocks_jit`` ``:988``): y = (JTJ + shift I) v straight from
the Gram blocks, the product behind every ``--inner cg`` PCG and tCG
trip. On a CUDA tensor it launches ``csrc/matvec.cu`` (one launch per
product) or raises; on a CPU tensor it runs :func:`gn_matvec_blocks_plain`
(gather, einsum, ``index_add_``). A loop of products with the same
blocks checks and lays them out once (:func:`matvec_plan`) and calls
:func:`matvec_apply` per product.

:func:`sweep_blocks_visits` replaces the third, ``_visits_kernel``
(``sweep_pallas.py:439``, launched by ``sweep_blocks_visits`` ``:582``;
the JAX package reaches it only under ``jax.vmap``, through the
``custom_vmap`` rule of ``_sweep_vmappable`` ``:719``): the same pass for
V cluster visits, each operand either per visit or shared by all. On a
CUDA tensor it is the same kernel at V visits (one launch, the visit a
grid axis of its own) or raises; on a CPU tensor it runs
:func:`sweep_blocks_visits_plain`. The solvers reach it through
:class:`Lanes`, the layout of an in-flight cluster group
(``solvers/sage.py``): V visits folded into the row and chunk axes, so
everything after the sweep sees V K chunks. A shared operand is read
once from memory and served to the other visits from L2 (notes in
``csrc/sweep.cu``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from sagecal_tpu_torch import dtypes
from sagecal_tpu_torch.ops import cuda_lib
from sagecal_tpu_torch.parallel import row_sums
from sagecal_tpu_torch.solvers import normal_eq as ne


def sweep_flops_per_row(md: int = 4) -> int:
    """float32 operations per row visit for one chunk at block width
    md, counted from the kernel body: A = C Jq^H, Bm = Jp C, V = Jp A
    (56 each), residual, squared weights and weighted residual (24),
    acceptance cost (24), the symmetric pp/qq blocks (2 x 2 S sums x 4
    terms x 3, S = md (md + 1) / 2), the pq block (4 md^2 x 2 x 3), the
    gradients (4 md x 4 x 2), and at md = 1 the phase rotations (8 x
    6)."""
    S = md * (md + 1) // 2
    return (168 + 48 + 48 * S + 24 * md * md + 32 * md
            + (48 if md == 1 else 0))


#: hybrid-chunk cap, as in the JAX package
MAX_CHUNKS = 4


def n_out(md: int = 4) -> int:
    """The caller layout's element count per (chunk, baseline): pp 2
    md^2, qq 2 md^2, pq 4 md^2, jtep 2 md, jteq 2 md, cost 1 (145, 41,
    13)."""
    return 8 * md * md + 4 * md + 1


#: words of one (chunk, baseline) block record on the card, per md: at md
#: = 4 the 145 of the caller layout padded to 640 bytes, so that every
#: block row starts on 16 bytes (the matvec's float4 loads) and a record
#: on 128; at md = 2 and 1 the 41 and 13 padded to 44 and 16, so that
#: every block row of md words starts on a multiple of md words (the
#: matvec's float2 and float loads)
REC_WORDS = {4: 160, 2: 44, 1: 16}


def rec_parts(md: int = 4) -> tuple:
    """The record's parts (``csrc/sweep.cu``) at block width md: pp, qq,
    pq, jtep, jteq as (offset, shape, strides) in words; the caller
    layout's order, so the baseline's cost follows at n_out(md) - 1."""
    m2 = md * md
    return ((0, (2, md, md), (m2, md, 1)), (2 * m2, (2, md, md), (m2, md, 1)),
            (4 * m2, (2, 2, md, md), (2 * m2, m2, md, 1)),
            (8 * m2, (2, md), (md, 1)), (8 * m2 + 2 * md, (2, md), (md, 1)))


#: the full-Jones (md = 4) layout: caller elements, record words, parts
N_OUT = n_out(4)
REC = REC_WORDS[4]
REC_PARTS = rec_parts(4)
#: the sweep kernel's tile (one baseline per lane of a warp) and its
#: largest thread block cluster (portable size)
SWEEP_TILE = 32
MAX_CLUSTER = 8
#: a sweep block's fixed work (zeroing its shared sums, the cluster
#: barriers, the epilogue over its tile's records) in timeslot steps,
#: as :func:`sweep_geometry` weighs it against the rows a block walks
BLOCK_STEPS = 8
#: warps of one matvec block (``MV_WARPS`` in ``csrc/matvec.cu``)
MATVEC_WARPS = 8

def matvec_flops_per_baseline(md: int = 4) -> int:
    """float32 operations per (chunk, baseline) of one blocks matvec at
    block width md: 12 md^2 multiply-adds (pp and qq 2 md^2 each per side,
    pq 4 md^2 each way; 192 at md = 4)."""
    return 2 * 12 * md * md

#: kernel launches since the last reset (the plain versions never count):
#: the sweep kernel called by :func:`sweep_blocks`, the matvec kernel, and
#: the sweep kernel called by :func:`sweep_blocks_visits`; the same
#: launches by block width, {("sweep" | "matvec" | "visits", md): n}, and
#: the sweep kernel's by storage dtype of its rows, {("sweep" | "visits",
#: "f32" | "bf16" | "f16"): n}
LAUNCHES = 0
MATVEC_LAUNCHES = 0
VISITS_LAUNCHES = 0
MD_LAUNCHES: dict = {}
ST_LAUNCHES: dict = {}

#: the sweep kernel's row storage dtypes: (code of ``sweep_launch``, name)
STORAGE = {torch.float32: (0, "f32"), torch.bfloat16: (1, "bf16"),
           torch.float16: (2, "f16")}


def reset_launches() -> None:
    global LAUNCHES, MATVEC_LAUNCHES, VISITS_LAUNCHES
    LAUNCHES = 0
    MATVEC_LAUNCHES = 0
    VISITS_LAUNCHES = 0
    MD_LAUNCHES.clear()
    ST_LAUNCHES.clear()


def _count_md(kernel: str, md: int) -> None:
    MD_LAUNCHES[(kernel, md)] = MD_LAUNCHES.get((kernel, md), 0) + 1


def supported(kmax: int, row_period: int, B: int) -> bool:
    """True when the fused sweep applies: baseline-major [tilesz, nbase]
    rows and a bounded hybrid-chunk count."""
    return (1 <= kmax <= MAX_CHUNKS and row_period > 0
            and B % row_period == 0)


class GNBlocks(NamedTuple):
    """Per-(chunk, baseline) Gram blocks of the Gauss-Newton operator.

    pp, qq [K, nb, 2, md, md]; pq [K, nb, 2, 2, md, md]; D [K, N, 2, md,
    md] the station-aggregated diagonal blocks (md = 4 full Jones, 2
    diag, 1 phase)."""

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


def _round(p, st):
    """Real planes ``p`` rounded through the storage dtype ``st`` and
    back (the JAX kernel's ``q()``, ``sweep_pallas.py:223-230``)."""
    return p.to(st).float()


def _cmul(xr, xi, yr, yi):
    """(re, im) of x y, every product and sum a float32 operation of its
    own (no fused multiply-add)."""
    return xr * yr - xi * yi, xr * yi + xi * yr


def _planes(C, Jp, Jq):
    """The (re, im) planes of A = C Jq^H, Bm = Jp C and V = Jp A, each
    [..., 2, 2] float32, formed as ``_sweep_body`` forms them and as the
    kernel's reduced instances do (``csrc/sweep.cu`` ``cmul_re``): a sum
    over the inner index of complex products, every operation rounded on
    its own. C [..., 2, 2] complex; Jp, Jq broadcast against it. The
    reduced policies round these planes to the storage dtype, so the
    kernel and the plain version must form the same float32 values: a
    complex matrix product (fused multiply-adds, another order) leaves
    some an ulp away, and one next to a storage tie rounds the other
    way."""
    Cr, Ci = C.real, C.imag
    Pr, Pi, Qr, Qi = Jp.real, Jp.imag, Jq.real, Jq.imag
    Ar = Ai = Br = Bi = None
    for e in range(2):          # A[d, o] = sum_e C[d, e] conj(Q[o, e])
        tr, ti = _cmul(Cr[..., :, e, None], Ci[..., :, e, None],
                       Qr[..., None, :, e], -Qi[..., None, :, e])
        Ar = tr if Ar is None else Ar + tr
        Ai = ti if Ai is None else Ai + ti
    Vr = Vi = None
    for d in range(2):          # Bm[a, o] = sum_d P[a, d] C[d, o]; V too
        pr, pi = Pr[..., :, d, None], Pi[..., :, d, None]
        tr, ti = _cmul(pr, pi, Cr[..., None, d, :], Ci[..., None, d, :])
        ur, ui = _cmul(pr, pi, Ar[..., None, d, :], Ai[..., None, d, :])
        Br = tr if Br is None else Br + tr
        Bi = ti if Bi is None else Bi + ti
        Vr = ur if Vr is None else Vr + ur
        Vi = ui if Vi is None else Vi + ui
    return Ar, Ai, Br, Bi, Vr, Vi


def _phase_factors(Ar, Ai, Br, Bi, Jp, Jq):
    """Phase mode's rotated factor planes FA [..., c, o, 2, 1] and FB
    [..., c, a, 2, 1] (``normal_eq._mode_factors``) from the A and Bm
    planes, every operation rounded on its own as in ``_sweep_body``:
    u = Jp_cc A[c, o] gives FA = (-Im u, Re u), w = conj(Jq_cc) Bm[a, c]
    gives FB = (Im w, -Re w)."""
    jr = torch.stack([Jp.real[..., 0, 0], Jp.real[..., 1, 1]], -1)[
        ..., None]                                   # [..., c, 1]
    ji = torch.stack([Jp.imag[..., 0, 0], Jp.imag[..., 1, 1]], -1)[
        ..., None]
    ur, ui = _cmul(jr, ji, Ar, Ai)                   # [..., c, o]
    qr = torch.stack([Jq.real[..., 0, 0], Jq.real[..., 1, 1]], -1)[
        ..., None]
    qi = torch.stack([Jq.imag[..., 0, 0], Jq.imag[..., 1, 1]], -1)[
        ..., None]
    br, bi = Br.transpose(-1, -2), Bi.transpose(-1, -2)     # [..., c, a]
    wr = qr * br + qi * bi
    wi = qr * bi - qi * br
    return (torch.stack([-ui, ur], -1)[..., None],
            torch.stack([wi, -wr], -1)[..., None])


def _sweep_rows(x, C, Jp, Jq, jones: str, st, reduced: bool):
    """The per-row pieces of the sweep, rows x, C [T, nb, ...] each with
    its own chunk's Jones Jp, Jq (broadcast against [T, nb, 2, 2]): the
    residual r [T, nb, 8] and the Wirtinger factors (fa, fb [T, nb, 2,
    2, 4] full; FA, FB the mode factors otherwise)."""
    T, nb = x.shape[:2]

    def q(p):
        return _round(p, st) if reduced else p

    if reduced:
        Ar, Ai, Br, Bi, Vr, Vi = _planes(C, Jp, Jq)
        A = torch.complex(q(Ar), q(Ai))              # the rounded planes
        Bm = torch.complex(q(Br), q(Bi))
        vm = torch.stack([q(Vr), q(Vi)], -1)
    else:
        A = C @ Jq.conj().transpose(-1, -2)          # [T, nb, 2, 2]
        Bm = Jp @ C
        vm = torch.view_as_real(Jp @ A)
    r = x - vm.reshape(T, nb, 8)
    if jones == "full":
        return (r,) + _factors(A, Bm)                # [T, nb, 2, 2, 4]
    # FA [T, nb, c, o, ri, md], FB [T, nb, c, a, ri, md]
    if jones == "phase" and reduced:
        return (r,) + tuple(q(f) for f in _phase_factors(Ar, Ai, Br, Bi,
                                                          Jp, Jq))
    return (r,) + ne._mode_factors(A, Bm, Jp, Jq, jones)


def _sweep_sums(r, fa, fb, w, cw, jones: str):
    """One chunk's sums over the rows (their weights ``w``, ``cw`` [T, nb,
    8] zero outside the chunk): (pp, qq, pq, jtep, jteq, cost) of
    :func:`sweep_blocks_plain`, the weighted factors each output shares
    formed once."""
    T, nb = r.shape[:2]
    w2 = (w * w).reshape(T, nb, 2, 2, 2)             # [T, nb, a, o, ri]
    rw2 = (r.reshape(T, nb, 2, 2, 2)) * w2
    if jones == "full":
        wfa = w2[..., None] * fa[:, :, None]         # [T, nb, a, o, r, i]
        wfb = w2[..., None] * fb[:, :, :, None]      # [T, nb, a, o, r, i]
        pp = torch.einsum("tbaori,tborj->baij", wfa, fa)
        qq = torch.einsum("tbaori,tbarj->boij", wfb, fb)
        pq = torch.einsum("tbaori,tbarj->baoij", wfa, fb)
        jtep = torch.einsum("tbaor,tbori->bai", rw2, fa)
        jteq = torch.einsum("tbaor,tbari->boi", rw2, fb)
    else:
        WFA = w2[..., None] * fa
        WFB = w2.transpose(2, 3)[..., None] * fb
        pp = torch.einsum("tbcorm,tbcorn->bcmn", WFA, fa)
        qq = torch.einsum("tbcarm,tbcarn->bcmn", WFB, fb)
        pq = torch.einsum("tbcorm,tbocrn->bcomn", WFA, fb)
        jtep = torch.einsum("tbcor,tbcorm->bcm", rw2, fa)
        jteq = torch.einsum("tbcar,tbcarm->bcm", rw2.transpose(2, 3), fb)
    cost = ((r * cw) ** 2).sum()
    return pp, qq, pq, jtep, jteq, cost


def sweep_blocks_plain(x8, Jp, Jq, coh, chunk_id, wt, cost_wt, nb: int,
                       jones: str = "full"):
    """Plain PyTorch version of the fused sweep.

    x8/wt/cost_wt [B, 8] real; Jp/Jq [K, nb, 2, 2] complex (per-baseline
    Jones of each chunk, constrained here to the mode ``jones``); coh [B,
    2, 2] complex; chunk_id [B]. Returns (pp, qq, pq, jtep, jteq, cost) in
    the caller layouts [K, nb, ...] (blocks md wide) and cost [K]. The
    diag and phase blocks come from the mode factors of the JAX kernel's
    ``_sweep_body`` (``normal_eq._mode_factors``).

    The per-row pieces (model, residual, factors) are formed once, each
    row with its own chunk's Jones (:func:`_sweep_rows`); each chunk then
    sums every row with the weights 0 outside it (:func:`_sweep_sums`),
    the values of one row pass per chunk, bit for bit.

    Under a reduced storage dtype (x8/wt/cost_wt in bf16 or f16) the
    rows widen to float32 and the outputs are float32; the model planes
    and the Wirtinger factors, formed by :func:`_planes`, are rounded
    through the storage dtype at the JAX kernel's boundary: A and Bm
    (full, diag), the phase mode's rotated planes built from the
    unrounded A and Bm, and the model V."""
    K = Jp.shape[0]
    T = x8.shape[0] // nb
    st = x8.dtype
    reduced = dtypes.is_reduced(st)
    if reduced:
        x8, wt, cost_wt = dtypes.pet(x8, wt, cost_wt)
    Jp = ne.jones_constrain(Jp, jones)
    Jq = ne.jones_constrain(Jq, jones)
    x = x8.reshape(T, nb, 8)
    C = coh.reshape(T, nb, 2, 2)
    w = wt.reshape(T, nb, 8)
    cw = cost_wt.reshape(T, nb, 8)
    cid = chunk_id.reshape(T, nb)
    if K == 1:
        Jpr, Jqr = Jp[0], Jq[0]
    else:
        bl = torch.arange(nb, device=cid.device)
        Jpr, Jqr = Jp[cid, bl], Jq[cid, bl]          # [T, nb, 2, 2]
    rows = _sweep_rows(x, C, Jpr, Jqr, jones, st, reduced)
    outs = []
    for k in range(K):
        mk = (cid == k).to(x.dtype)[..., None] if K > 1 else 1.0
        outs.append(_sweep_sums(*rows, w * mk, cw * mk, jones))
    return tuple(torch.stack([o[i] for o in outs]) for i in range(6))


def record_views(out, md: int = 4):
    """(pp, qq, pq, jtep, jteq) at block width md as strided views of
    contiguous block records ``out`` [..., nb, R] (R >= :func:`n_out`
    words: :data:`REC_WORDS` on the card), e.g. [K, nb, R] or [V, K, nb,
    R]."""
    lead, st = out.shape[:-1], out.stride()[:-1]
    base = out.storage_offset()
    return tuple(out.as_strided(lead + shp, st + inner, base + o)
                 for o, shp, inner in rec_parts(md))


class SweepGeometry(NamedTuple):
    """Launch geometry of the sweep kernel, which the kernel reads as
    given, the same for each of the V visits of a launch: ``tiles``
    tiles of :data:`SWEEP_TILE` baselines, each (visit, tile) taken by
    one cluster of ``cluster`` blocks. Block ``rank`` of a cluster walks
    timeslots ``times[rank]`` .. ``times[rank + 1]`` of its tile for
    every chunk (a row goes to the sums of its own chunk id), then sums
    the cluster's record words ``words[last][rank]`` ..
    ``words[last][rank + 1]`` of the tile's K x nbt x rec words
    (chunk-major, then baseline, then word) and writes them: ``last`` is
    1 on the last tile (nbt = nb - SWEEP_TILE (tiles - 1)), 0 on the
    others (nbt = SWEEP_TILE). The records are ``rec`` words apart
    (:data:`REC_WORDS` of the mode's md)."""

    tiles: int
    cluster: int
    times: tuple
    words: tuple
    rec: int


def sweep_geometry(T: int, nb: int, K: int, slots: int, V: int = 1,
                   cluster: int | None = None,
                   md: int = 4) -> SweepGeometry:
    """The sweep kernel's launch geometry for V visits of T timeslots of
    nb baselines and K chunks on a card that holds ``slots`` blocks at
    once. The cluster size C (<= :data:`MAX_CLUSTER`, <= T) is the one
    whose C V tiles blocks finish first: ceil(C V tiles / slots) waves,
    each of ceil(T / C) timeslot steps plus :data:`BLOCK_STEPS` of a
    block's fixed work, ties to the larger C. At V = 1 that is the
    largest cluster with which every block runs in the first wave, where
    one exists. ``cluster`` takes that C instead of choosing it
    (``tools_dev/torch_sweep_clusters.py`` times the choices). The time
    ranges are as even as the timeslots allow, and each tile's record
    words (:data:`REC_WORDS` of block width ``md``) are split evenly among
    its blocks."""
    if T < 1 or nb < 1 or not 1 <= K <= MAX_CHUNKS or V < 1 or slots < 1 \
            or md not in REC_WORDS:
        raise ValueError(f"sweep_geometry: T={T}, nb={nb}, K={K}, V={V}, "
                         f"slots={slots}, md={md}")
    rec = REC_WORDS[md]
    tiles = -(-nb // SWEEP_TILE)
    best = None
    choices = range(1, min(MAX_CLUSTER, T) + 1) if cluster is None \
        else (min(cluster, MAX_CLUSTER, T),)
    for c0 in choices:
        tl = -(-T // c0)
        c = -(-T // tl)
        steps = -(-c * V * tiles // slots) * (tl + BLOCK_STEPS)
        if best is None or steps <= best[0]:
            best = (steps, c, tl)
    _, c, tl = best

    def split(nbt):
        total = K * nbt * rec
        span = -(-total // c)
        return tuple(min(total, r * span) for r in range(c + 1))

    return SweepGeometry(
        tiles=tiles, cluster=c,
        times=tuple(min(T, r * tl) for r in range(c + 1)),
        words=(split(min(SWEEP_TILE, nb)),
               split(nb - SWEEP_TILE * (tiles - 1))),
        rec=rec)


@functools.lru_cache(maxsize=64)
def _geometry_args(T: int, nb: int, K: int, slots: int, V: int = 1,
                   md: int = 4):
    """(geometry, its time bounds, its word bounds) as the C arrays
    ``sweep_launch`` takes, built once per shape and md."""
    geo = sweep_geometry(T, nb, K, slots, V, md=md)
    row = ctypes.c_int * (MAX_CLUSTER + 1)
    return (geo, row(*geo.times),
            (ctypes.c_int * (2 * MAX_CLUSTER + 2))(
                *(w for part in geo.words
                  for w in part + (0,) * (MAX_CLUSTER - geo.cluster))))


@functools.lru_cache(maxsize=64)
def _visit_strides(*strides):
    """The visit strides of the six operands as the C array
    ``sweep_launch`` takes, built once per combination."""
    return (ctypes.c_longlong * 6)(*strides)


#: the single visit's strides (every operand read at visit 0)
_NO_STRIDES = _visit_strides(0, 0, 0, 0, 0, 0)


_SLOTS: dict = {}
_TICKETS: dict = {}


def _sweep_slots(dev, K: int, md: int = 4, st: int = 0) -> int:
    """Blocks of the sweep kernel the card ``dev`` holds at once at K
    chunks, block width md and row storage code st (:data:`STORAGE`; the
    CUDA occupancy query, cached)."""
    key = (dev.index, K, md, st)
    n = _SLOTS.get(key)
    if n is None:
        per_sm = cuda_lib.load("sweep").sweep_blocks_per_sm(K, md, st)
        if per_sm < 1:
            raise RuntimeError("sweep kernel: the occupancy query failed "
                               f"at K={K}, md={md}, st={st}")
        sms = torch.cuda.get_device_properties(dev).multi_processor_count
        n = _SLOTS[key] = per_sm * sms
    return n


def _ticket(dev, stream: int):
    """The sweep kernel's last-block ticket for (device, stream): one
    int32, zero between launches (the last block resets it)."""
    key = (dev.index, stream)
    t = _TICKETS.get(key)
    if t is None:
        t = torch.zeros(1, dtype=torch.int32, device=dev)
        _TICKETS[key] = t
    return t


def _aligned(t):
    """``t`` contiguous with its data on 16 bytes (the kernels' float4
    loads): as it is when it already is, else a copy."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _int64(t):
    """``t`` as contiguous int64 (as it is when it already is)."""
    if t.dtype != torch.int64:
        t = t.long()
    return t.contiguous()


def visit_strides(x8, wt, cost_wt, chunk_id, coh, J) -> tuple:
    """The sweep kernel's visit strides of its six operands, as it reads
    them: the elements between two visits' data (floats, complex values
    as (re, im) pairs; int64 chunk ids) of an operand with a leading [V]
    axis, 0 for one that all visits share."""
    return tuple(
        a[0].numel() * (2 if a.is_complex() else 1)
        if a.dim() == nd + 1 else 0
        for a, nd in ((x8, 2), (wt, 2), (cost_wt, 2), (chunk_id, 1),
                      (coh, 3), (J, 4)))


def _sweep_cuda(x8, J, coh, sta1, sta2, chunk_id, wt, cost_wt, nb: int,
                V: int, visits: bool, md: int = 4):
    """One launch of the sweep kernel over V visits at block width md.
    Each operand carries a leading [V] axis (one more dimension than a
    single visit's x8/wt/cost_wt [B, 8], coh [B, 2, 2], chunk_id [B], J
    [K, N, 2, 2]) or is shared by all visits; the callers check the visit
    axes. J is read as it is: at md < 4 the kernel zeroes the
    off-diagonals itself. Returns the records [V K, nb, REC_WORDS[md]]
    and cost [V K]; ``visits`` picks the launch counter."""
    global LAUNCHES, VISITS_LAUNCHES
    dev = x8.device
    what = "visits" if visits else "sweep"
    if x8.dtype not in STORAGE:
        raise TypeError(f"{what} kernel: x8 must be float32, bfloat16 or "
                        f"float16 (got {x8.dtype})")
    for name, a in (("x8", x8), ("wt", wt), ("cost_wt", cost_wt)):
        if a.dtype != x8.dtype or a.device != dev:
            raise TypeError(f"{what} kernel: {name} must be {x8.dtype} on "
                            f"{dev}, the storage dtype of x8 (got {a.dtype} "
                            f"on {a.device})")
    st_code, st_name = STORAGE[x8.dtype]
    if coh.dtype != torch.complex64 or J.dtype != torch.complex64 \
            or coh.device != dev or J.device != dev:
        raise TypeError(f"{what} kernel: coherencies and Jones must be "
                        f"complex64 on {dev}")
    K, N = J.shape[-4], J.shape[-3]
    B = x8.shape[-2]
    T = B // nb
    if not 1 <= K <= MAX_CHUNKS or T < 1 or wt.shape[-2] != B \
            or cost_wt.shape[-2] != B or coh.shape[-3] != B \
            or chunk_id.shape[-1] != B \
            or sta1.shape[0] < nb or sta2.shape[0] < nb \
            or sta1.device != dev or sta2.device != dev \
            or chunk_id.device != dev:
        raise ValueError(f"{what} kernel: K={K} (1..{MAX_CHUNKS}), {B} rows "
                         "and per-row operands of equal length on "
                         f"{dev} expected")
    # the kernel reads complex64 as (re, im) float pairs and the indices
    # as int64, the solvers' own layouts: no copy on the main path
    x8, wt, cost_wt, coh, J = (_aligned(a.resolve_conj())
                               for a in (x8, wt, cost_wt, coh, J))
    s1, s2, cid = (_int64(a) for a in (sta1, sta2, chunk_id))
    strides = _visit_strides(*visit_strides(
        x8, wt, cost_wt, cid, coh, J)) if V > 1 else _NO_STRIDES
    geo, times, words = _geometry_args(T, nb, K,
                                       _sweep_slots(dev, K, md, st_code),
                                       V, md)
    rec = geo.rec
    # the records, then cost [V K], then the tiles' costs [V K, tiles]
    n_rec = V * K * nb * rec
    buf = torch.empty(n_rec + V * K * (1 + geo.tiles), dtype=torch.float32,
                      device=dev)
    out = buf.as_strided((V * K, nb, rec), (nb * rec, rec, 1))
    cost = buf.as_strided((V * K,), (1,), n_rec)
    ptr = buf.data_ptr()
    stream = cuda_lib.stream_ptr(dev)
    cuda_lib.check(cuda_lib.load("sweep").sweep_launch(
        x8.data_ptr(), wt.data_ptr(), cost_wt.data_ptr(), cid.data_ptr(),
        coh.data_ptr(), J.data_ptr(), s1.data_ptr(), s2.data_ptr(), ptr,
        ptr + 4 * n_rec, ptr + 4 * (n_rec + V * K),
        _ticket(dev, stream).data_ptr(), T, nb, K, N, V, md, st_code,
        strides, geo.cluster, times, words, stream), "sweep_cluster_kernel")
    if visits:
        VISITS_LAUNCHES += 1
    else:
        LAUNCHES += 1
    _count_md(what, md)
    ST_LAUNCHES[(what, st_name)] = ST_LAUNCHES.get((what, st_name), 0) + 1
    return out, cost


def sweep_blocks(x8, J, coh, sta1, sta2, chunk_id, wt, cost_wt,
                 row_period: int, kmax: int, jones: str = "full"):
    """The fused cluster-visit pass (``sweep_pallas.sweep_blocks``).

    x8/wt/cost_wt [B, 8] real; J [K, N, 2, 2] complex; coh [B, 2, 2];
    sta1/sta2/chunk_id [B] (baseline-periodic: only the first
    ``row_period`` stations are used); ``jones`` the Jones mode, of block
    width md (``normal_eq.jones_mdim``), J constrained to it. Returns (pp
    [K, nb, 2, md, md], qq [K, nb, 2, md, md], pq [K, nb, 2, 2, md, md],
    jtep [K, nb, 2, md], jteq [K, nb, 2, md], cost [K])."""
    md = ne.jones_mdim(jones)
    nb = int(row_period)
    K = int(kmax)
    if J.shape[0] != K or x8.shape[0] % nb:
        raise ValueError(f"sweep_blocks: J has {J.shape[0]} chunks for "
                         f"kmax={K}, or {x8.shape[0]} rows are not a "
                         f"multiple of row_period={nb}")
    if x8.device.type == "cuda":
        out, cost = _sweep_cuda(x8, J, coh, sta1, sta2, chunk_id, wt,
                                cost_wt, nb, 1, False, md)
        return record_views(out, md) + (cost,)
    s1b = sta1[:nb].long()
    s2b = sta2[:nb].long()
    Jp = J[:, s1b]                                   # [K, nb, 2, 2]
    Jq = J[:, s2b]
    return sweep_blocks_plain(x8, Jp, Jq, coh, chunk_id, wt, cost_wt, nb,
                              jones)


class Lanes(NamedTuple):
    """V cluster visits solved as one problem (an in-flight group of
    ``solvers/sage.py``), folded into the axes the solvers batch over:
    rows [V B] with visit v's rows at v B .. (v + 1) B, chunks [V K] with
    visit v's chunk k at v K + k (its chunk ids offset by v K). A per-row
    operand that every visit shares stays [B, ...]. ``cid`` holds the
    visits' own chunk ids (0 .. K - 1, int64 as the solvers hold them,
    which the sweep kernel reads without a copy) for the sweep: [B] when
    all visits have the same, else [V, B].

    A batch of solve intervals (``sagefit_host_tiles``) folds its tiles'
    visits the same way, tile-major: ``tiles`` tiles of V / tiles visits
    each, every per-row operand (data, coherencies, weights) per visit;
    the solvers then report the tCG products per tile."""

    V: int
    K: int
    cid: torch.Tensor
    tiles: int = 1

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
                              nb: int, vsize: int, jones: str = "full"):
    """Plain PyTorch version of the multi-visit sweep: each operand
    carries a leading [V] axis or is one array shared by all V visits
    (x8/wt/cost_wt [(V,) B, 8], Jp/Jq [(V,) K, nb, 2, 2], coh [(V,) B, 2,
    2], chunk_id [(V,) B]). Returns the :func:`sweep_blocks_plain` tuple
    (Jones mode ``jones``) with a leading [V] on every output."""
    def pick(a, ndim, v):
        return a[v] if a.dim() == ndim + 1 else a

    outs = [sweep_blocks_plain(pick(x8, 2, v), pick(Jp, 4, v),
                               pick(Jq, 4, v), pick(coh, 3, v),
                               pick(chunk_id, 1, v), pick(wt, 2, v),
                               pick(cost_wt, 2, v), nb, jones)
            for v in range(int(vsize))]
    return tuple(torch.stack([o[i] for o in outs]) for i in range(6))


def sweep_blocks_visits(x8, J, coh, sta1, sta2, chunk_id, wt, cost_wt,
                        row_period: int, kmax: int, vsize: int,
                        jones: str = "full"):
    """V cluster visits in one pass (``sweep_pallas.sweep_blocks_visits``).

    Each of x8/wt/cost_wt [(V,) B, 8], J [(V,) K, N, 2, 2], coh [(V,) B,
    2, 2] and chunk_id [(V,) B] carries a leading [V] axis or is one
    array shared by every visit (the JAX package's static ``batched``
    6-tuple, read here off the ranks); sta1/sta2 are shared and
    baseline-periodic. Returns the :func:`sweep_blocks` tuple with a
    leading [V] axis on every output. On the card this is one launch of
    the sweep kernel at V visits (V the group's real member count), and
    the outputs are views of one [V K, nb, REC_WORDS[md]] record buffer, so
    the
    visits fold into the chunk axis without a copy."""
    md = ne.jones_mdim(jones)
    nb, K, V = int(row_period), int(kmax), int(vsize)
    if J.shape[-4] != K or x8.shape[-2] % nb \
            or any(a.dim() == nd + 1 and a.shape[0] != V
                   for a, nd in ((x8, 2), (J, 4), (coh, 3), (chunk_id, 1),
                                 (wt, 2), (cost_wt, 2))):
        raise ValueError(f"sweep_blocks_visits: J has {J.shape[-4]} chunks "
                         f"for kmax={K}, rows are not a multiple of "
                         f"row_period={nb}, or a batched operand's visit "
                         f"axis is not {V}")
    if J.device.type == "cuda":
        out, cost = _sweep_cuda(x8, J, coh, sta1, sta2, chunk_id, wt,
                                cost_wt, nb, V, True, md)
        return record_views(out.view(V, K, nb, out.shape[-1]), md) \
            + (cost.view(V, K),)
    s1b = sta1[:nb].long()
    s2b = sta2[:nb].long()
    Jp = J.index_select(-3, s1b)                     # [(V,) K, nb, 2, 2]
    Jq = J.index_select(-3, s2b)
    return sweep_blocks_visits_plain(x8, Jp, Jq, coh, chunk_id, wt, cost_wt,
                                     nb, V, jones)


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
              jones: str = "full", lanes: Lanes | None = None, rows=None,
              live=None):
    """Operator assembly from one fused sweep: (GNBlocks, JTe [K, 8N],
    cost [K]) — ``sweep_pallas.gn_blocks``. With ``lanes`` the rows and
    chunks are a group's folded layout (K = V lanes.K), and one
    multi-visit sweep replaces the JAX package's vmapped sweep
    (``sweep_pallas._sweep_dispatch``).

    With ``rows`` (a ``parallel.RowGroup``: this rank's whole timeslots
    of the tile) the sweep's per-baseline record is summed over the
    ranks in one collective: pp, qq, pq, the cost, and the station
    aggregates D and JTe, formed from the rank's own blocks first (on
    the card ``index_add_`` sums repeated stations in atomic order, so
    aggregating the summed blocks on every rank could leave two ranks'
    D a few bits apart; the summed aggregates are the same bits on every
    rank). The blocks are then the whole tile's, so the matvec and the
    damped solves run replicated, with no collective a PCG or tCG
    trip. ``live`` (the indices of the solve's chunk mask) sums those
    chunks only: a cluster of fewer hybrid chunks than kmax carries
    padded chunks that hold no row, whose records are 0 on every
    rank."""
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
    pp, qq, pq, D, JTe, cost = row_sums((pp, qq, pq, D, JTe, cost), rows,
                                        "sweep", live)
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


def shifted_solve(A, b, reduced: bool = False):
    """Solve A dp = b batched over chunks by Cholesky, or by LU when
    ``reduced`` (the bf16/f16 storage policies, as the JAX package does):
    (dp, ok), ok = factorization succeeded and dp finite, per chunk."""
    if reduced:
        dp, info = torch.linalg.solve_ex(A, b[..., None])
        dp = dp[..., 0]
    else:
        L, info = torch.linalg.cholesky_ex(A)
        dp = torch.cholesky_solve(b[..., None], L)[..., 0]
    return dp, (info == 0) & torch.isfinite(dp).all(dim=-1)


def retry_damped(solve, shift, diag_max):
    """A damped solve with its ONE retry: ``solve(shift)`` gives (dp, ok)
    per chunk; a chunk that fails is solved again with the shift boosted
    by 1e-3 ``diag_max``, and one that fails again returns dp = 0. The
    retry is computed for every chunk and selected per chunk, so the call
    never waits on the device."""
    dp, ok = solve(shift)
    dp2, ok2 = solve(shift + 1e-3 * torch.clamp(diag_max, min=1e-30))
    zero = torch.zeros_like(dp)
    dpw = torch.where(ok[:, None], dp, torch.where(ok2[:, None], dp2, zero))
    return dpw, ok | ok2


def chol_solve_blocks_shift(fac: GNBlocks, JTe, shift, sta1, sta2,
                            n_stations: int, reduced: bool = False):
    """One batched assemble + factor + solve of (JTJ + shift I) dp =
    JTe (:func:`shifted_solve`: LU when ``reduced``); returns (dp, ok)."""
    return shifted_solve(_assemble_damped(fac, shift, sta1, sta2,
                                          n_stations), JTe, reduced)


def solve_damped_blocks(fac: GNBlocks, JTe, mu, jitter, sta1, sta2,
                        n_stations: int, reduced: bool = False, rho=0.0):
    """Solve (JTJ + (mu + jitter + rho) I) dp = JTe batched over chunks (by
    LU when ``reduced``), with :func:`retry_damped`'s one retry, its boost
    read from the D blocks' diagonals plus the ADMM ``rho`` (a scalar or
    [K]; ``sweep_pallas.solve_damped_blocks``: the blocks are never
    rho-augmented, rho rides the shift)."""
    dd = torch.diagonal(fac.D, dim1=-2, dim2=-1)
    diag_max = dd.reshape(dd.shape[0], -1).abs().amax(dim=-1) + rho
    return retry_damped(
        lambda shift: chol_solve_blocks_shift(fac, JTe, shift, sta1, sta2,
                                              n_stations, reduced),
        mu + jitter + rho, diag_max)


def normal_equations_fused(x8, J, coh, sta1, sta2, chunk_id, wt,
                           n_stations: int, kmax: int, row_period: int,
                           cost_wt=None, jones: str = "full",
                           lanes: Lanes | None = None, rows=None,
                           live=None):
    """Dense (JTJ [K, 8N, 8N], JTe, cost) from one fused sweep
    (``sweep_pallas.normal_equations_fused``): the blocks expanded by
    :func:`_assemble_damped` without a shift (summed over ``rows`` as
    :func:`gn_blocks` sums them)."""
    fac, JTe, cost = gn_blocks(x8, J, coh, sta1, sta2, chunk_id, wt,
                               n_stations, kmax, row_period,
                               cost_wt=cost_wt, jones=jones, lanes=lanes,
                               rows=rows, live=live)
    return _assemble_damped(fac, None, sta1, sta2, n_stations), JTe, cost


def pq_layouts(fac: GNBlocks) -> tuple:
    """The pq blocks [K, nb, a, o, i, j] laid out contiguous as the plain
    matvec's two products read them, [K, nb, a, i, j, o] and [K, nb, o,
    j, a, i]: copied once per Gram-block set (``matvec_plan``) instead of
    on every product. Each product's sum runs in the order it ran before
    the layouts were kept (j, then o; a, then i): the same values, bit for
    bit."""
    return (fac.pq.permute(0, 1, 2, 4, 5, 3).contiguous(),
            fac.pq.permute(0, 1, 3, 5, 2, 4).contiguous())


def gn_matvec_blocks_plain(fac: GNBlocks, v, s1b, s2b, n_stations: int,
                           shift=None, pqs=None):
    """Plain PyTorch version of the blocks matvec: v [K, 2 md N] gathered
    per baseline, the block products of ``_matvec_kernel`` as einsums,
    ``index_add_`` per station, then ``shift * v`` (shift [K] or a
    scalar). ``pqs``: the pq blocks' :func:`pq_layouts` (made here unless
    given)."""
    K, nb = fac.pp.shape[0], fac.pp.shape[1]
    md = fac.pp.shape[-1]
    pq_p, pq_q = pq_layouts(fac) if pqs is None else pqs
    vr = v.reshape(K, n_stations, 2, md)
    vp = vr[:, s1b]                                  # [K, nb, 2, md]
    vq = vr[:, s2b]
    yp = (torch.einsum("kbaij,kbaj->kbai", fac.pp, vp)
          + torch.einsum("kbaijo,kbjo->kbai", pq_p, vq.transpose(2, 3)))
    yq = (torch.einsum("kboji,kboi->kboj", fac.qq, vq)
          + torch.einsum("kbojai,kbai->kboj", pq_q, vp))
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
    where n = s1[b] and 1 where n = s2[b], in a fixed order; ``runs``
    [N, MATVEC_WARPS, 2] the kernel's split of each station's entries
    among its warps (:func:`matvec_runs`)."""

    s1: torch.Tensor
    s2: torch.Tensor
    ptr: torch.Tensor
    ent: torch.Tensor
    runs: torch.Tensor


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
                          for t in (s1b, s2b, ptr, ent, matvec_runs(ptr))))


def _block_view(t, nb: int):
    """(tensor, words between consecutive baselines) with each baseline's
    block contiguous and its rows of md words on 4 md bytes, as the matvec
    kernel reads them (one load of the row's width): an aligned strided
    view of the sweep's records (:data:`REC_WORDS` apart) is used as it is,
    anything else is copied."""
    md = t.shape[-1]
    words = math.prod(t.shape[2:])
    st = t.stride()
    if t[0, 0].is_contiguous() and st[0] == nb * st[1] and st[1] >= words \
            and st[1] % md == 0 and t.data_ptr() % (4 * md) == 0:
        return t, st[1]
    return _aligned(t), words


def matvec_runs(ptr, warps: int = MATVEC_WARPS):
    """The matvec kernel's split of the station lists, which it reads as
    given: [N, warps, 2] (start, end) of the run of ``ent`` entries each
    warp of a station's block walks (contiguous runs of ceil(count /
    warps), the last ones shorter or empty). ``ptr`` [N + 1] as in
    :class:`StationLists`."""
    ptr = torch.as_tensor(ptr, dtype=torch.int64)
    e0, e1 = ptr[:-1, None], ptr[1:, None]
    per = (e1 - e0 + warps - 1) // warps
    w0 = e0 + torch.arange(warps, device=ptr.device) * per
    return torch.stack([torch.minimum(w0, e1), torch.minimum(e1, w0 + per)],
                       dim=-1)


class MatvecPlan(NamedTuple):
    """What :func:`matvec_apply` needs of one Gram-block set, checked and
    laid out once (:func:`matvec_plan`). On the card ``params`` is the
    kernel's filled argument record and ``keep`` the tensors it points
    into; on the CPU ``params`` is None and the plain version runs."""

    fac: GNBlocks
    n_stations: int
    shift: object
    s1b: torch.Tensor
    s2b: torch.Tensor
    params: object
    launch: object
    keep: tuple


def _check_lists(lists: StationLists, nb: int, N: int, dev) -> None:
    s1, s2, ptr, ent, runs = lists
    if s1.shape != (nb,) or s2.shape != (nb,) or ptr.shape != (N + 1,) \
            or ent.shape != (2 * nb,) or runs.shape != (N, MATVEC_WARPS, 2):
        raise ValueError(f"matvec: station lists for {s1.shape[0]} "
                         f"baselines and {ptr.shape[0] - 1} stations, "
                         f"expected {nb} and {N}")
    if any(t.dtype != torch.int32 or t.device != dev for t in lists):
        raise TypeError(f"matvec: station lists must be int32 on {dev}")


def matvec_plan(fac: GNBlocks, sta1, sta2, n_stations: int, shift=None,
                lists: StationLists | None = None) -> MatvecPlan:
    """Check and lay out the blocks ``fac`` once for every product
    (JTJ + shift I) v taken with them (:func:`matvec_apply`): the solvers
    build one plan per Gram-block set (a tCG operator, a PCG solve) and
    call the kernel through it, at the blocks' width md (4 full Jones, 2
    diag, 1 phase). Raises on blocks of mismatched shapes, dtypes or
    devices, on ``lists`` that are not the layout's, and on the card for
    anything but float32; nothing falls back."""
    pp, qq, pq = fac.pp, fac.qq, fac.pq
    K, nb = pp.shape[0], pp.shape[1]
    md = pp.shape[-1]
    N = int(n_stations)
    if pp.shape != (K, nb, 2, md, md) or qq.shape != pp.shape \
            or pq.shape != (K, nb, 2, 2, md, md):
        raise ValueError(f"matvec: blocks of shapes {tuple(pp.shape)}, "
                         f"{tuple(qq.shape)}, {tuple(pq.shape)}")
    dev = pp.device
    if any(t.dtype != pp.dtype or t.device != dev for t in (qq, pq)):
        raise TypeError("matvec: pp, qq and pq must share dtype and device")
    if shift is not None and torch.as_tensor(shift).numel() not in (1, K):
        raise ValueError(f"matvec: shift of {torch.as_tensor(shift).numel()}"
                         f" values for {K} chunks")
    if dev.type != "cuda":
        if lists is not None:
            _check_lists(lists, nb, N, lists.s1.device)
        return MatvecPlan(fac, N, shift, sta1[:nb].long(), sta2[:nb].long(),
                          None, None, pq_layouts(fac))
    if md not in REC_WORDS:
        raise ValueError(f"matvec: block width {md} is none of "
                         f"{tuple(REC_WORDS)}")
    if pp.dtype != torch.float32:
        raise TypeError(f"matvec kernel: blocks must be float32 on {dev} "
                        f"(got {pp.dtype})")
    if lists is None:
        lists = station_lists(sta1, sta2, nb, N)
    _check_lists(lists, nb, N, dev)
    (pp, sp), (qq, sq), (pq, spq) = (_block_view(t, nb) for t in (pp, qq, pq))
    sh = None
    if shift is not None:
        sh = torch.as_tensor(shift, device=dev).to(torch.float32)
        sh = sh.expand(K).contiguous()
    s1, s2, _, ent, runs = lists
    params = cuda_lib.MatvecParams(
        pp.data_ptr(), qq.data_ptr(), pq.data_ptr(), sp, sq, spq,
        s1.data_ptr(), s2.data_ptr(), runs.data_ptr(), ent.data_ptr(),
        None if sh is None else sh.data_ptr(), K, nb, N, md)
    return MatvecPlan(fac, N, shift, s1, s2, params,
                      cuda_lib.load("matvec").matvec_launch,
                      (pp, qq, pq, sh, lists))


def matvec_apply(plan: MatvecPlan, v):
    """(JTJ + shift I) v for the blocks of ``plan``: v [K, 2 md N]. On
    the card one launch of ``csrc/matvec.cu``; the call checks only
    ``v``."""
    global MATVEC_LAUNCHES
    if plan.params is None:
        return gn_matvec_blocks_plain(plan.fac, v, plan.s1b, plan.s2b,
                                      plan.n_stations, plan.shift,
                                      pqs=plan.keep)
    p = plan.params
    if v.dtype != torch.float32 or not v.is_cuda \
            or v.shape != (p.K, 2 * p.md * p.N):
        raise TypeError(f"matvec kernel: v must be float32 [{p.K}, "
                        f"{2 * p.md * p.N}] on the card (got {v.dtype} "
                        f"{tuple(v.shape)} on {v.device})")
    if v.device != plan.fac.pp.device:
        raise TypeError(f"matvec kernel: v on {v.device}, blocks on "
                        f"{plan.fac.pp.device}")
    v = _aligned(v)
    y = torch.empty_like(v)
    cuda_lib.check(plan.launch(
        ctypes.addressof(p), v.data_ptr(), y.data_ptr(),
        cuda_lib.stream_ptr(v.device)), "matvec_station_kernel")
    MATVEC_LAUNCHES += 1
    _count_md("matvec", p.md)
    return y


def gn_matvec_blocks(fac: GNBlocks, v, sta1, sta2, n_stations: int,
                     shift=None, lists: StationLists | None = None):
    """(JTJ + shift I) @ v from the per-baseline Gram blocks
    (``sweep_pallas.gn_matvec_blocks``): v [K, 2 md N], shift [K] or None;
    sta1/sta2 the rows' station indices (baseline-periodic). One
    :func:`matvec_plan` and one :func:`matvec_apply`: a loop that takes
    many products with the same blocks builds the plan once itself. On
    the card the kernel walks ``lists`` (:func:`station_lists` of the
    same rows), built for this call when not given."""
    return matvec_apply(matvec_plan(fac, sta1, sta2, n_stations, shift=shift,
                                    lists=lists), v)
