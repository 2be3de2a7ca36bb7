// Fused LM sweep on Hopper (CUDA C++, sm_90a), for one cluster visit or V
// visits in one launch, in each Jones mode: full (block width md = 4),
// diagonal (md = 2) and phase-only (md = 1).
//
// Replaces two TPU kernels of sagecal_tpu/ops/sweep_pallas.py:
// _sweep_kernel (maths in _sweep_body, launched by sweep_blocks) and
// _visits_kernel (the same body for V stacked cluster visits in one
// grid, launched by sweep_blocks_visits). One pass over a visit's rows:
// model V = Jp C Jq^H, residual r = x - V, the Wirtinger factors of
// A = C Jq^H and Bm = Jp C, and per (visit v, hybrid chunk k, baseline b)
// the time-summed Gram blocks pp/qq [2,md,md], pq [2,2,md,md], the
// gradients jtep/jteq [2,md] and the acceptance cost sum (r cw)^2. The
// TPU kernel masks the rows of other chunks by folding (cid == k) into
// the weights, once per chunk; here each row is read once and added to
// the sums of its own chunk (same sums for finite data). Each of x, w,
// cw, the chunk ids, the coherencies and the Jones carries a visit
// stride, 0 when one array is shared by all visits (the TPU kernel's
// static `batched` tuple); the single-visit sweep is the case V = 1.
//
// What bounds it on this card: bytes. A row is 32 words read once (x, w,
// cw and the coherency, 8 each) plus, at K > 1, its chunk id (one word
// as the TPU kernel's int32; the port reads the solvers' int64) against
// ~1200 float32 operations (sweep_flops_per_row in ops/sweep.py): at
// T = 120, nb = 1891 the row stream is 29 MB a visit (30 MB with the
// ids), and with the records written the bound is 9.0 us at K = 1 and
// 10.3 us at K = 4 at 3.35 TB/s; a shared operand is read once for all
// V visits, so V = 4 with shared weights needs 17 words a row a visit
// (chip_smoke.py's counts). The first port kept all 121 sums of a (chunk,
// baseline, time slice) in one thread's registers (248-254 registers,
// 8 warps an SM), wrote per-slice partials and summed them in a second
// launch, with the Jones gathered and the cost summed by further
// launches: about five launches a multi-visit call.
//
// Design (sweep_cluster_kernel, one launch for any V; instantiated for
// V = 1, where every visit offset is compiled away, and for V > 1):
//  - a tile is 32 baselines, one per lane. A block is three warps over
//    the same (visit, tile) and time range, one per role: warps 0 and 1
//    own pp[a], pq[a] and jtep[a] for a = 0, 1 (46 sums each), warp 2
//    owns qq, jteq and the cost (29 sums). Each recomputes the cheap
//    per-row products it needs (A, a row or all of Bm and V) from the
//    same row, which the three warps read from L1/L2; no warp keeps more
//    than 46 sums, and the branch on the role is uniform over each warp;
//  - the grid is (C, V, tiles): a thread block cluster of C blocks
//    (C <= 8) takes the C time ranges of one (visit, tile), and the
//    visit is a grid dimension the clusters do not span. Blocks are
//    numbered rank fastest, then visit, then tile, so the V visits of a
//    (tile, time range) run as neighbouring clusters and a shared row is
//    read once from memory and served to the others from L2, as the TPU
//    kernel fetches a shared block once per time block. C, the ranges
//    and each block's share of the tile's record words in the epilogue
//    are the wrapper's (ops/sweep.py:sweep_geometry, which weighs C
//    against the waves the V visits take), passed in and checked at
//    launch to cover each timeslot and word once;
//  - each lane routes a row to the sums of the row's chunk: it keeps one
//    chunk's sums in registers, with that chunk's two Jones read from
//    J [(V,) K, N, 2, 2] through sta1/sta2 (no gather launch), and on a
//    change of chunk adds them to its own column of the block's
//    shared-memory sums [K][32][121] at md = 4 (so rows of any chunk-id
//    pattern are counted once, and no block exists for a chunk with no
//    rows);
//  - after a cluster barrier the C blocks sum the C blocks' shared sums
//    through distributed shared memory, in rank order, and write the
//    tile's records [K, 32, REC] of their visit with neighbouring
//    threads on neighbouring words (each block a share of the words). A
//    per-block bit mask of the chunks it saw skips sums that are all
//    zero;
//  - rank 0 of each cluster sums its tile's cost per chunk (a fixed
//    shuffle tree) into tile_cost [V K, tiles]; the block that finishes
//    last of the whole grid (an atomic ticket after a memory fence)
//    sums those in tile order into cost [V K], four (visit, chunk) pairs
//    at a time, and resets the ticket, so the caller needs no sum
//    launch;
//  - each lane loads the next row's operands before it sums the current
//    one, so their latency hides behind the ~300 multiply-adds a row.
// Records at md = 4 are REC = 160 words (pp 0, qq 32, pq 64, jtep 128,
// jteq 136, cost 144, zeros to 160): 640 bytes, so every block row is
// 16-byte aligned for the matvec's float4 loads, which read the V K
// records of a group in place. No float atomics and a fixed order
// everywhere: two calls on the same inputs give the same bits. The
// strides and the geometry are read with constant indices, so the
// arguments stay in the parameter bank (through a pointer they went to
// local memory: 43.3 us against 41.7 us at K = 4). One instantiation
// for every V cost the single-visit sweep 1-2 us on an H100 (its visit
// offsets, and chunk ids read as int32 at a runtime stride); the V = 1
// instantiation has the registers and time of a kernel without the
// visit axis. Registers, spills and device times are in PERF.md's
// kernel table (chip_smoke.py reads them from nvcc -Xptxas -v).
//
// Constrained Jones modes (--jones diag|phase; the TPU kernel's `jones`
// argument of _sweep_body, which picks md at trace time): md is a
// template parameter, so md = 4 compiles to the full-Jones kernel above
// and md = 2 and 1 are two more instantiations of the same code (for
// both V = 1 and V > 1). What bounds them is the same row stream: the
// rows are 32 words whatever md is, and only the sums shrink, to 37 at
// md = 2 (pp 6 + qq 6 packed upper triangles, pq 16, jtep 4, jteq 4,
// cost 1) and 13 at md = 1. The three role warps stay (13 + 13 + 11 and
// 4 + 4 + 5 sums), each with far fewer registers, and the shared sums
// shrink to [K][32][37] and [K][32][13], so more blocks fit an SM.
//  - The kernel constrains J itself: at md < 4 it zeroes the
//    off-diagonal entries of the two Jones it reads (the TPU wrapper
//    multiplies J by the identity before its kernel), so the
//    off-diagonals never leak into A = C Jq^H or Bm = Jp C, and the call
//    stays one launch.
//  - Diagonal mode reads the d == c planes of the full factors: for
//    station p the Re/Im pair of A[a][o] (row a, the station's own
//    diagonal index), for station q that of Bm[a][o].
//  - Phase mode rotates those planes by the Jones diagonals:
//    u = i Jp_aa A[a][o] gives the p factor (-Im u, Re u), and
//    w = conj(Jq_oo) Bm[a][o] the q factor (Im w, -Re w).
//  - Records: the caller layout of md (pp 2 md^2, qq 2 md^2, pq 4 md^2,
//    jtep 2 md, jteq 2 md, cost: 41 words at md = 2, 13 at md = 1) padded
//    to 44 and 16 words. Every block starts on a multiple of md words,
//    so the matvec reads a block row of md words with one aligned load
//    (float2 at md = 2, float at md = 1; csrc/matvec.cu).
//
// Reduced storage (--dtype-policy bf16|f16; the TPU kernels' `reduced`
// and `st`, which _sweep_body applies through q()): the storage type ST
// of the rows x, w and cw is a template parameter, float, __nv_bfloat16
// or __half, for each md and both visit forms. What differs:
//  - the rows are read as ST and widened to float at the load: a row's
//    8 components are 16 bytes, one 16-byte load (8 bytes for a role
//    warp's half row), so a row is 12 words of rows plus the coherency's
//    8 and, at K > 1, the chunk id. The coherencies and J are complex64
//    under every policy;
//  - the model V = Jp A and the factor planes are rounded to nearest
//    even through ST and back (Rows<ST>::round) where q() rounds them:
//    the A and Bm planes at md = 4 and 2, the rotated planes at md = 1
//    (built from the unrounded A and Bm), and V before the residual.
//    A, Bm and V themselves are computed from unrounded planes, and
//    every sum is float32;
//  - the planes that are rounded (A, Bm, V, the rotated planes) are
//    formed with every product and sum rounded on its own, in the order
//    of _sweep_body (cmul_re, cmul_im), and the plain version forms them
//    the same way (ops/sweep.py:_planes): a fused multiply-add would
//    leave a plane an ulp from the plain version's, and a plane next to
//    a tie of the storage type would then round the other way, moving a
//    block by a storage ulp of that row's share (up to 3.2e-4 of the
//    largest block at full width, bf16, K = 4, when the plain version
//    formed its planes by complex matrix products);
//  - the float instance's round is the identity and its planes keep the
//    contracted arithmetic, so its code is the float32 kernel's as it
//    was.

#include <type_traits>

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cooperative_groups.h>

namespace cg = cooperative_groups;

// sweep_cluster_kernel: a tile of 32 baselines, three role warps
#define SC_TILE 32
#define SC_THREADS 96
#define SC_MAX_K 4
#define SC_MAX_CLUSTER 8
#define SC_EPI 4

// the sums and records of block width MD (4 full, 2 diag, 1 phase).
// Canonical sum index q: pp [2][S] (packed upper triangles), qq [2][S],
// pq [2][2][MD][MD], jtep [2][MD], jteq [2][MD], cost; role warps 0 and
// 1 own pp[a], pq[a] and jtep[a] (NP sums), role 2 qq, jteq and the cost
// (NQ). REC: the record's words (the caller layout's NOUT padded).
template <int MD>
struct Lay {
    static constexpr int S = MD * (MD + 1) / 2;
    static constexpr int NP = S + 2 * MD * MD + MD;
    static constexpr int NQ = 2 * S + 2 * MD + 1;
    static constexpr int NACC = 2 * NP + NQ;
    static constexpr int Q_PP = 0;
    static constexpr int Q_QQ = 2 * S;
    static constexpr int Q_PQ = 4 * S;
    static constexpr int Q_JP = 4 * S + 4 * MD * MD;
    static constexpr int Q_JQ = Q_JP + 2 * MD;
    static constexpr int Q_COST = Q_JQ + 2 * MD;
    static constexpr int NOUT = 8 * MD * MD + 4 * MD + 1;
    static constexpr int REC = MD == 4 ? 160 : (MD == 2 ? 44 : 16);
};

// index of (i, j), i <= j, in the packed upper triangle of an MD x MD
// block
template <int MD>
__host__ __device__ __forceinline__ int sym_pair(int i, int j)
{
    return i * MD - (i * (i - 1)) / 2 + (j - i);
}

__device__ __forceinline__ void load8(const float* p, float* v)
{
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

__device__ __forceinline__ void load4(const float* p, float* v)
{
    const float4 a = *reinterpret_cast<const float4*>(p);
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
}

// the rows' storage type ST: loads that widen to float, and the rounding
// through ST of the TPU kernel's q() (the identity for float)
template <typename ST>
struct Rows;

template <>
struct Rows<float> {
    static __device__ __forceinline__ void row8(const float* p, float* v)
    {
        load8(p, v);
    }
    static __device__ __forceinline__ void row4(const float* p, float* v)
    {
        load4(p, v);
    }
    static __device__ __forceinline__ float round(float v) { return v; }
};

template <>
struct Rows<__nv_bfloat16> {
    static __device__ __forceinline__ void row8(const __nv_bfloat16* p,
                                                float* v)
    {
        const uint4 a = *reinterpret_cast<const uint4*>(p);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 f = __bfloat1622float2(h[i]);
            v[2 * i] = f.x;
            v[2 * i + 1] = f.y;
        }
    }
    static __device__ __forceinline__ void row4(const __nv_bfloat16* p,
                                                float* v)
    {
        const uint2 a = *reinterpret_cast<const uint2*>(p);
        const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&a);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const float2 f = __bfloat1622float2(h[i]);
            v[2 * i] = f.x;
            v[2 * i + 1] = f.y;
        }
    }
    static __device__ __forceinline__ float round(float v)
    {
        return __bfloat162float(__float2bfloat16_rn(v));
    }
};

template <>
struct Rows<__half> {
    static __device__ __forceinline__ void row8(const __half* p, float* v)
    {
        const uint4 a = *reinterpret_cast<const uint4*>(p);
        const __half2* h = reinterpret_cast<const __half2*>(&a);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            const float2 f = __half22float2(h[i]);
            v[2 * i] = f.x;
            v[2 * i + 1] = f.y;
        }
    }
    static __device__ __forceinline__ void row4(const __half* p, float* v)
    {
        const uint2 a = *reinterpret_cast<const uint2*>(p);
        const __half2* h = reinterpret_cast<const __half2*>(&a);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
            const float2 f = __half22float2(h[i]);
            v[2 * i] = f.x;
            v[2 * i + 1] = f.y;
        }
    }
    static __device__ __forceinline__ float round(float v)
    {
        return __half2float(__float2half_rn(v));
    }
};

// output element e of the caller layout -> canonical sum index q
template <int MD>
__device__ __forceinline__ int out_to_acc(int e)
{
    using L = Lay<MD>;
    constexpr int B2 = 2 * MD * MD;             // words of pp (or qq)
    if (e < 2 * B2) {                           // pp (e < B2) or qq
        const int base = e < B2 ? L::Q_PP : L::Q_QQ;
        const int r = e < B2 ? e : e - B2;
        const int s = r / (MD * MD), i = (r / MD) % MD, j = r % MD;
        return base + s * L::S
            + (i <= j ? sym_pair<MD>(i, j) : sym_pair<MD>(j, i));
    }
    if (e < 4 * B2) return L::Q_PQ + (e - 2 * B2);
    if (e < 4 * B2 + 2 * MD) return L::Q_JP + (e - 4 * B2);
    if (e < 4 * B2 + 4 * MD) return L::Q_JQ + (e - 4 * B2 - 2 * MD);
    return L::Q_COST;
}

// x y of two complex values, (re, im), for the planes that the reduced
// instances round to their storage type: every product and difference
// rounded on its own (no fused multiply-add), as the plain version
// (ops/sweep.py:_planes) and _sweep_body form them, so that both round
// the same float32 planes. The float instance keeps the contracted
// arithmetic of the float32 kernel.
__device__ __forceinline__ float cmul_re(float xr, float xi, float yr,
                                         float yi)
{
    return __fsub_rn(__fmul_rn(xr, yr), __fmul_rn(xi, yi));
}

__device__ __forceinline__ float cmul_im(float xr, float xi, float yr,
                                         float yi)
{
    return __fadd_rn(__fmul_rn(xr, yi), __fmul_rn(xi, yr));
}

// A = C Jq^H [d][o] of a row: C, Q entries e = row * 2 + col, (re, im)
template <typename ST>
__device__ __forceinline__ void prod_a(const float* cv, const float* Q,
                                       float Ar[2][2], float Ai[2][2])
{
#pragma unroll
    for (int d = 0; d < 2; ++d) {
#pragma unroll
        for (int o = 0; o < 2; ++o) {
            float zr = 0.f, zi = 0.f;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
                const float xr = cv[(d * 2 + e) * 2];
                const float xi = cv[(d * 2 + e) * 2 + 1];
                const float yr = Q[(o * 2 + e) * 2];
                const float yi = -Q[(o * 2 + e) * 2 + 1];
                if constexpr (std::is_same<ST, float>::value) {
                    zr += xr * yr - xi * yi;
                    zi += xr * yi + xi * yr;
                } else {
                    zr = __fadd_rn(zr, cmul_re(xr, xi, yr, yi));
                    zi = __fadd_rn(zi, cmul_im(xr, xi, yr, yi));
                }
            }
            Ar[d][o] = zr;
            Ai[d][o] = zi;
        }
    }
}

// row a of Bm = Jp C and of V = Jp A
template <typename ST>
__device__ __forceinline__ void prod_row(const float* cv, const float* P,
                                         const float Ar[2][2],
                                         const float Ai[2][2], int a,
                                         float* Br, float* Bi, float* Vr,
                                         float* Vi)
{
#pragma unroll
    for (int o = 0; o < 2; ++o) {
        float br = 0.f, bi = 0.f, vr = 0.f, vi = 0.f;
#pragma unroll
        for (int d = 0; d < 2; ++d) {
            const float pr = P[(a * 2 + d) * 2];
            const float pi = P[(a * 2 + d) * 2 + 1];
            const float cr = cv[(d * 2 + o) * 2];
            const float ci = cv[(d * 2 + o) * 2 + 1];
            if constexpr (std::is_same<ST, float>::value) {
                br += pr * cr - pi * ci;
                bi += pr * ci + pi * cr;
                vr += pr * Ar[d][o] - pi * Ai[d][o];
                vi += pr * Ai[d][o] + pi * Ar[d][o];
            } else {
                br = __fadd_rn(br, cmul_re(pr, pi, cr, ci));
                bi = __fadd_rn(bi, cmul_im(pr, pi, cr, ci));
                vr = __fadd_rn(vr, cmul_re(pr, pi, Ar[d][o], Ai[d][o]));
                vi = __fadd_rn(vi, cmul_im(pr, pi, Ar[d][o], Ai[d][o]));
            }
        }
        Br[o] = br;
        Bi[o] = bi;
        Vr[o] = vr;
        Vi[o] = vi;
    }
}

// the station-p factor FA(a, o, ri, m), m < MD, of a row (_ma_entry of the
// TPU kernel, and its diag and phase forms), each plane rounded through
// the storage type ST (q()). Ar/Ai: A [d][o], unrounded.
template <int MD, typename ST>
__device__ __forceinline__ void factor_p(const float Ar[2][2],
                                         const float Ai[2][2],
                                         const float* P, int a, int o,
                                         int ri, float* fa)
{
    using R = Rows<ST>;
    if constexpr (MD == 4) {
        // fa[m], m = d * 2 + ci: every d
#pragma unroll
        for (int d = 0; d < 2; ++d) {
            fa[d * 2] = ri == 0 ? R::round(Ar[d][o]) : R::round(Ai[d][o]);
            fa[d * 2 + 1] = ri == 0 ? -R::round(Ai[d][o])
                                    : R::round(Ar[d][o]);
        }
    } else if constexpr (MD == 2) {
        // the d == a plane: (Re, Im) of the diagonal entry j_aa
        fa[0] = ri == 0 ? R::round(Ar[a][o]) : R::round(Ai[a][o]);
        fa[1] = ri == 0 ? -R::round(Ai[a][o]) : R::round(Ar[a][o]);
    } else {
        // u = i Jp_aa A[a][o]: (-Im u, Re u)
        const float pr = P[a * 6], pi = P[a * 6 + 1];
        float ur, ui;
        if constexpr (std::is_same<ST, float>::value) {
            ur = pr * Ar[a][o] - pi * Ai[a][o];
            ui = pr * Ai[a][o] + pi * Ar[a][o];
        } else {
            ur = cmul_re(pr, pi, Ar[a][o], Ai[a][o]);
            ui = cmul_im(pr, pi, Ar[a][o], Ai[a][o]);
        }
        fa[0] = R::round(ri == 0 ? -ui : ur);
    }
}

// the station-q factor FB(o, a, ri, m), m < MD, of a row (_mb_entry and
// its diag and phase forms), rounded through ST. Br/Bi: row a of Bm [d],
// unrounded.
template <int MD, typename ST>
__device__ __forceinline__ void factor_q(const float* Br, const float* Bi,
                                         const float* Q, int o, int ri,
                                         float* fb)
{
    using R = Rows<ST>;
    if constexpr (MD == 4) {
#pragma unroll
        for (int d = 0; d < 2; ++d) {
            fb[d * 2] = ri == 0 ? R::round(Br[d]) : R::round(Bi[d]);
            fb[d * 2 + 1] = ri == 0 ? R::round(Bi[d]) : -R::round(Br[d]);
        }
    } else if constexpr (MD == 2) {
        // the d == o plane
        fb[0] = ri == 0 ? R::round(Br[o]) : R::round(Bi[o]);
        fb[1] = ri == 0 ? R::round(Bi[o]) : -R::round(Br[o]);
    } else {
        // w = conj(Jq_oo) Bm[a][o]: (Im w, -Re w)
        const float qr = Q[o * 6], qi = Q[o * 6 + 1];
        float wr, wi;
        if constexpr (std::is_same<ST, float>::value) {
            wr = qr * Br[o] + qi * Bi[o];
            wi = qr * Bi[o] - qi * Br[o];
        } else {
            wr = __fadd_rn(__fmul_rn(qr, Br[o]), __fmul_rn(qi, Bi[o]));
            wi = __fsub_rn(__fmul_rn(qr, Bi[o]), __fmul_rn(qi, Br[o]));
        }
        fb[0] = R::round(ri == 0 ? wi : -wr);
    }
}

// canonical sum index of a role's accumulator r
template <int ROLE, int MD>
__device__ __forceinline__ int role_q(int r)
{
    using L = Lay<MD>;
    if (ROLE < 2) {
        if (r < L::S) return L::Q_PP + ROLE * L::S + r;
        if (r < L::S + 2 * MD * MD)
            return L::Q_PQ + ROLE * 2 * MD * MD + (r - L::S);
        return L::Q_JP + ROLE * MD + (r - L::S - 2 * MD * MD);
    }
    if (r < 2 * L::S) return L::Q_QQ + r;
    if (r < 2 * L::S + 2 * MD) return L::Q_JQ + (r - 2 * L::S);
    return L::Q_COST;
}

// one row into a role's sums. Roles 0 and 1 (a = ROLE): pp[a] (S, packed
// upper triangle), pq[a][o][i][j] (2 MD^2), jtep[a][i] (MD). Role 2:
// qq[o] (2 x S), jteq[o][i] (2 MD), cost (1). The model V is rounded
// through ST before the residual (q() of the TPU kernel's vm).
template <int ROLE, int MD, typename ST>
__device__ __forceinline__ void role_row(const float* xv, const float* wv,
                                         const float* cwv, const float* cv,
                                         const float* P, const float* Q,
                                         float* acc)
{
    constexpr int S = Lay<MD>::S;
    using R = Rows<ST>;
    float Ar[2][2], Ai[2][2];
    prod_a<ST>(cv, Q, Ar, Ai);
    if (ROLE < 2) {
        const int a = ROLE;
        float Br[2], Bi[2], Vr[2], Vi[2];
        prod_row<ST>(cv, P, Ar, Ai, a, Br, Bi, Vr, Vi);
        // xv, wv hold components (o, ri) of row a
#pragma unroll
        for (int o = 0; o < 2; ++o) {
#pragma unroll
            for (int ri = 0; ri < 2; ++ri) {
                const int c = o * 2 + ri;
                const float r = xv[c]
                    - R::round(ri == 0 ? Vr[o] : Vi[o]);
                const float ww = wv[c] * wv[c];
                const float rw = r * ww;
                float fa[MD], fb[MD];
                factor_p<MD, ST>(Ar, Ai, P, a, o, ri, fa);
                factor_q<MD, ST>(Br, Bi, Q, o, ri, fb);
#pragma unroll
                for (int i = 0; i < MD; ++i) {
                    const float wa = ww * fa[i];
#pragma unroll
                    for (int j = i; j < MD; ++j)
                        acc[sym_pair<MD>(i, j)] += wa * fa[j];
#pragma unroll
                    for (int j = 0; j < MD; ++j)
                        acc[S + (o * MD + i) * MD + j] += wa * fb[j];
                    acc[S + 2 * MD * MD + i] += rw * fa[i];
                }
            }
        }
    } else {
        float Br[2][2], Bi[2][2], Vr[2][2], Vi[2][2];
        prod_row<ST>(cv, P, Ar, Ai, 0, Br[0], Bi[0], Vr[0], Vi[0]);
        prod_row<ST>(cv, P, Ar, Ai, 1, Br[1], Bi[1], Vr[1], Vi[1]);
#pragma unroll
        for (int a = 0; a < 2; ++a) {
#pragma unroll
            for (int o = 0; o < 2; ++o) {
#pragma unroll
                for (int ri = 0; ri < 2; ++ri) {
                    const int c = (a * 2 + o) * 2 + ri;
                    const float r = xv[c]
                        - R::round(ri == 0 ? Vr[a][o] : Vi[a][o]);
                    const float ww = wv[c] * wv[c];
                    const float rw = r * ww;
                    const float rc = r * cwv[c];
                    acc[2 * S + 2 * MD] += rc * rc;
                    float fb[MD];
                    factor_q<MD, ST>(Br[a], Bi[a], Q, o, ri, fb);
#pragma unroll
                    for (int i = 0; i < MD; ++i) {
                        const float wb = ww * fb[i];
#pragma unroll
                        for (int j = i; j < MD; ++j)
                            acc[o * S + sym_pair<MD>(i, j)] += wb * fb[j];
                        acc[2 * S + o * MD + i] += rw * fb[i];
                    }
                }
            }
        }
    }
}

// ST: the storage type of the rows x, w and cw
template <typename ST>
struct SweepArgs {
    const ST* x;             // [(V,) T nb, 8]
    const ST* w;             // [(V,) T nb, 8]
    const ST* cw;            // [(V,) T nb, 8]
    const long long* cid;    // [(V,) T nb], as the solvers hold them
    const float* coh;        // [(V,) T nb, 2, 2, re/im]
    const float* J;          // [(V,) K, N, 2, 2, re/im]
    const long long* s1;     // [nb] (the first row period of sta1)
    const long long* s2;
    float* out;              // [V K, nb, REC]
    float* cost;             // [V K]
    float* tile_cost;        // [V K, tiles]: each tile's cost, per chunk
    unsigned* ticket;        // one counter, 0 between launches
    // elements of each operand between two visits (0: shared by all)
    long long vx, vw, vcw, vcid, vcoh, vj;
    int T, nb, K, N;
    // the wrapper's launch geometry (ops/sweep.py:sweep_geometry): rank r
    // of a cluster walks timeslots tb[r] .. tb[r + 1] and writes the
    // record words wb[last][r] .. wb[last][r + 1] of its tile (last = 1
    // on the grid's last tile)
    int tb[SC_MAX_CLUSTER + 1];
    int wb[2][SC_MAX_CLUSTER + 1];
};

// add a lane's sums of chunk k to its column of the block's shared sums
template <int ROLE, int NS, int MD>
__device__ __forceinline__ void flush_sums(float* acc, float* sums, int k,
                                           int lane, unsigned* seen)
{
    float* col = sums + ((size_t)k * SC_TILE + lane) * Lay<MD>::NACC;
#pragma unroll
    for (int r = 0; r < NS; ++r) {
        col[role_q<ROLE, MD>(r)] += acc[r];
        acc[r] = 0.f;
    }
    atomicOr(seen, 1u << k);
}

// one row of visit v's operands for a role: the coherency, chunk id
// (K > 1) and the role's components of x and w (and all of cw for
// role 2)
template <int ROLE, typename ST>
__device__ __forceinline__ void load_row(const SweepArgs<ST>& p,
                                         long long v, size_t row, float* cv,
                                         float* xv, float* wv, float* cwv,
                                         long long& c)
{
    using R = Rows<ST>;
    c = p.K > 1 ? p.cid[v * p.vcid + row] : 0;
    load8(p.coh + v * p.vcoh + row * 8, cv);
    if (ROLE < 2) {
        R::row4(p.x + v * p.vx + row * 8 + ROLE * 4, xv);
        R::row4(p.w + v * p.vw + row * 8 + ROLE * 4, wv);
    } else {
        R::row8(p.x + v * p.vx + row * 8, xv);
        R::row8(p.w + v * p.vw + row * 8, wv);
        R::row8(p.cw + v * p.vcw + row * 8, cwv);
    }
}

// a chunk's Jones of one station, constrained to the mode: at MD < 4 the
// off-diagonal entries are zeroed (the TPU wrapper's J * I)
template <int MD>
__device__ __forceinline__ void load_jones(const float* j, float* P)
{
    load8(j, P);
    if (MD < 4) {
#pragma unroll
        for (int e = 2; e < 6; ++e) P[e] = 0.f;
    }
}

// a role warp's pass over its rows of visit v: sums of the current chunk
// in registers, added to the block's shared sums [K][32][NACC] on a
// change of chunk and at the end. The next row's operands are loaded
// before the current row is summed, so their latency hides behind the
// sums.
template <int ROLE, int MD, typename ST>
__device__ __forceinline__ void role_pass(const SweepArgs<ST>& p, int v,
                                          int b,
                                          int lane, int t0, int t1,
                                          float* sums, unsigned* seen)
{
    constexpr int NS = ROLE < 2 ? Lay<MD>::NP : Lay<MD>::NQ;
    float acc[NS];
#pragma unroll
    for (int r = 0; r < NS; ++r) acc[r] = 0.f;
    if (b >= p.nb || t0 >= t1) return;
    const long long st1 = p.s1[b], st2 = p.s2[b];
    const float* Jv = p.J + v * p.vj;
    float P[8], Q[8];
    long long cur = -1;
    bool ok = false;
    float cv[8], xv[8], wv[8], cwv[8];
    long long c;
    load_row<ROLE, ST>(p, v, (size_t)t0 * p.nb + b, cv, xv, wv, cwv, c);
    for (int t = t0; t < t1; ++t) {
        float cvn[8], xvn[8], wvn[8], cwvn[8];
        long long cn = 0;
        if (t + 1 < t1)
            load_row<ROLE, ST>(p, v, (size_t)(t + 1) * p.nb + b, cvn, xvn,
                               wvn, cwvn, cn);
        // at K = 1 every row is chunk 0 (the TPU kernel applies no mask)
        if (c != cur) {
            if (ok) flush_sums<ROLE, NS, MD>(acc, sums, (int)cur, lane, seen);
            cur = c;
            ok = c >= 0 && c < p.K;
            if (ok) {
                load_jones<MD>(Jv + ((size_t)c * p.N + st1) * 8, P);
                load_jones<MD>(Jv + ((size_t)c * p.N + st2) * 8, Q);
            }
        }
        if (ok) role_row<ROLE, MD, ST>(xv, wv, cwv, cv, P, Q, acc);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
            cv[e] = cvn[e];
            xv[e] = xvn[e];
            wv[e] = wvn[e];
            cwv[e] = cwvn[e];
        }
        c = cn;
    }
    if (ok) flush_sums<ROLE, NS, MD>(acc, sums, (int)cur, lane, seen);
}

// MULTI = false is the single-visit case: visit 0 of every operand, the
// visit offsets compiled away (a second instantiation of the same code,
// so that V = 1 keeps the registers and the speed of a kernel without
// the visit axis). MD: the Jones mode's block width. ST: the rows'
// storage type.
template <bool MULTI, int MD, typename ST>
__global__ void __launch_bounds__(SC_THREADS, 4)
sweep_cluster_kernel(const SweepArgs<ST> p)
{
    using L = Lay<MD>;
    extern __shared__ float sums[];             // [K][32][NACC]
    __shared__ unsigned seen;                   // chunks with rows here
    __shared__ bool last;
    cg::cluster_group cluster = cg::this_cluster();
    const int tid = threadIdx.x, lane = tid & 31, role = tid >> 5;
    const int rank = blockIdx.x, C = gridDim.x;
    const int v = MULTI ? (int)blockIdx.y : 0;
    const int tile = blockIdx.z, tiles = gridDim.z;
    const int b0 = tile * SC_TILE;
    const int nsum = p.K * SC_TILE * L::NACC;
    for (int i = tid; i < nsum; i += SC_THREADS) sums[i] = 0.f;
    if (tid == 0) seen = 0u;
    __syncthreads();

    // this block's share of the geometry, read with constant indices so
    // that the arguments stay in the parameter bank
    const bool last_tile = tile == tiles - 1;
    int t0 = 0, t1 = 0, w0 = 0, i1 = 0;
#pragma unroll
    for (int r = 0; r < SC_MAX_CLUSTER; ++r) {
        if (r == rank) {
            t0 = p.tb[r];
            t1 = p.tb[r + 1];
            w0 = last_tile ? p.wb[1][r] : p.wb[0][r];
            i1 = last_tile ? p.wb[1][r + 1] : p.wb[0][r + 1];
        }
    }
    if (role == 0)
        role_pass<0, MD, ST>(p, v, b0 + lane, lane, t0, t1, sums, &seen);
    else if (role == 1)
        role_pass<1, MD, ST>(p, v, b0 + lane, lane, t0, t1, sums, &seen);
    else
        role_pass<2, MD, ST>(p, v, b0 + lane, lane, t0, t1, sums, &seen);
    __syncthreads();
    cluster.sync();

    // the cluster's sums, rank by rank, into the tile's records of visit v
    unsigned masks = 0u;
    for (int r = 0; r < C; ++r)
        masks |= *cluster.map_shared_rank(&seen, r) << (SC_MAX_K * r);
    const int per_k = min(SC_TILE, p.nb - b0) * L::REC;
    float* out = p.out + (size_t)v * p.K * p.nb * L::REC;
    // SC_EPI words a thread at once, so that their remote loads overlap;
    // each word still sums the ranks in rank order
    for (int i0 = w0 + tid; i0 < i1; i0 += SC_EPI * SC_THREADS) {
        int off[SC_EPI], k[SC_EPI];
        size_t dst[SC_EPI];
        float s[SC_EPI];
#pragma unroll
        for (int u = 0; u < SC_EPI; ++u) {
            const int i = i0 + u * SC_THREADS;
            int rem = i;
            k[u] = 0;
            while (rem >= per_k) {
                rem -= per_k;
                ++k[u];
            }
            const int l = rem / L::REC;
            const int pos = rem - l * L::REC;
            off[u] = i < i1 && pos < L::NOUT
                ? (k[u] * SC_TILE + l) * L::NACC + out_to_acc<MD>(pos) : -1;
            dst[u] = i < i1 ? ((size_t)k[u] * p.nb + b0 + l) * L::REC + pos
                            : 0;
            s[u] = 0.f;
        }
        for (int r = 0; r < C; ++r) {
            const float* peer = cluster.map_shared_rank(sums, r);
#pragma unroll
            for (int u = 0; u < SC_EPI; ++u)
                if (off[u] >= 0 && ((masks >> (SC_MAX_K * r + k[u])) & 1u))
                    s[u] += peer[off[u]];
        }
#pragma unroll
        for (int u = 0; u < SC_EPI; ++u)
            if (i0 + u * SC_THREADS < i1) out[dst[u]] = s[u];
    }
    // the tile's cost per chunk: rank 0, one warp per chunk, a fixed tree
    if (rank == 0) {
        for (int k = role; k < p.K; k += SC_THREADS / 32) {
            const int off = (k * SC_TILE + lane) * L::NACC + L::Q_COST;
            float s = 0.f;
            for (int r = 0; r < C; ++r)
                if ((masks >> (SC_MAX_K * r + k)) & 1u)
                    s += cluster.map_shared_rank(sums, r)[off];
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
                s += __shfl_down_sync(0xffffffffu, s, o);
            if (lane == 0)
                p.tile_cost[((size_t)v * p.K + k) * tiles + tile] = s;
        }
    }
    cluster.sync();

    // the last block of the grid sums the tiles' costs in tile order:
    // SC_MAX_K (visit, chunk) pairs at a time, each thread a fixed set of
    // tiles of each, then a fixed shuffle tree and a fixed sum of the
    // warps' shares
    __threadfence();
    __syncthreads();
    if (tid == 0)
        last = atomicAdd(p.ticket, 1u)
            == gridDim.x * gridDim.y * gridDim.z - 1;
    __syncthreads();
    if (!last) return;
    __threadfence();
    float* red = sums;              // peers are done with it
    const int pairs = gridDim.y * p.K;
    for (int q0 = 0; q0 < pairs; q0 += SC_MAX_K) {
        if (q0 > 0) __syncthreads();    // the last pairs' shares are read
        float s[SC_MAX_K];
#pragma unroll
        for (int u = 0; u < SC_MAX_K; ++u) {
            s[u] = 0.f;
            if (q0 + u < pairs)
                for (int j = tid; j < tiles; j += SC_THREADS)
                    s[u] += __ldcg(p.tile_cost + (size_t)(q0 + u) * tiles
                                   + j);
        }
#pragma unroll
        for (int u = 0; u < SC_MAX_K; ++u) {
#pragma unroll
            for (int o = 16; o > 0; o >>= 1)
                s[u] += __shfl_down_sync(0xffffffffu, s[u], o);
            if (lane == 0) red[role * SC_MAX_K + u] = s[u];
        }
        __syncthreads();
        if (tid < SC_MAX_K && q0 + tid < pairs) {
            float c = 0.f;
            for (int w = 0; w < SC_THREADS / 32; ++w)
                c += red[w * SC_MAX_K + tid];
            p.cost[q0 + tid] = c;
        }
    }
    if (tid == 0) *p.ticket = 0u;
}

template <int MD>
static size_t cluster_smem(int K)
{
    return (size_t)K * SC_TILE * Lay<MD>::NACC * sizeof(float);
}

template <int MD, typename ST>
static cudaError_t smem_attr_st(void)
{
    cudaError_t err = cudaFuncSetAttribute(
        sweep_cluster_kernel<false, MD, ST>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)cluster_smem<MD>(SC_MAX_K));
    if (err == cudaSuccess)
        err = cudaFuncSetAttribute(
            sweep_cluster_kernel<true, MD, ST>,
            cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)cluster_smem<MD>(SC_MAX_K));
    return err;
}

template <int MD>
static cudaError_t smem_attr_md(void)
{
    cudaError_t err = smem_attr_st<MD, float>();
    if (err == cudaSuccess) err = smem_attr_st<MD, __nv_bfloat16>();
    if (err == cudaSuccess) err = smem_attr_st<MD, __half>();
    return err;
}

static cudaError_t cluster_smem_attr(void)
{
    static bool done = false;
    if (done) return cudaSuccess;
    cudaError_t err = smem_attr_md<4>();
    if (err == cudaSuccess) err = smem_attr_md<2>();
    if (err == cudaSuccess) err = smem_attr_md<1>();
    done = err == cudaSuccess;
    return err;
}

template <int MD, typename ST>
static int blocks_per_sm_md(int K)
{
    int n1 = 0, n2 = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n1, sweep_cluster_kernel<false, MD, ST>, SC_THREADS,
            cluster_smem<MD>(K)) != cudaSuccess
        || cudaOccupancyMaxActiveBlocksPerMultiprocessor(
            &n2, sweep_cluster_kernel<true, MD, ST>, SC_THREADS,
            cluster_smem<MD>(K)) != cudaSuccess)
        return 0;
    return min(n1, n2);
}

template <typename ST>
static int blocks_per_sm_st(int K, int md)
{
    return md == 4 ? blocks_per_sm_md<4, ST>(K)
        : (md == 2 ? blocks_per_sm_md<2, ST>(K)
           : (md == 1 ? blocks_per_sm_md<1, ST>(K) : 0));
}

// blocks of sweep_cluster_kernel an SM holds at K chunks, block width md
// and row storage type st (0 float, 1 bf16, 2 f16), the fewer of its two
// instantiations (0 on error)
extern "C" int sweep_blocks_per_sm(int K, int md, int st)
{
    if (cluster_smem_attr() != cudaSuccess) return 0;
    return st == 0 ? blocks_per_sm_st<float>(K, md)
        : (st == 1 ? blocks_per_sm_st<__nv_bfloat16>(K, md)
           : (st == 2 ? blocks_per_sm_st<__half>(K, md) : 0));
}

template <int MD, typename ST>
static cudaError_t launch_md(cudaLaunchConfig_t* cfg, const SweepArgs<ST>& p,
                             int V)
{
    cfg->dynamicSmemBytes = cluster_smem<MD>(p.K);
    return V == 1
        ? cudaLaunchKernelEx(cfg, sweep_cluster_kernel<false, MD, ST>, p)
        : cudaLaunchKernelEx(cfg, sweep_cluster_kernel<true, MD, ST>, p);
}

// fill the arguments of storage type ST (the geometry tb, wb checked by
// the caller) and launch at block width md
template <typename ST>
static cudaError_t launch_st(cudaLaunchConfig_t* cfg, const void* x,
                             const void* w, const void* cw,
                             const long long* cid, const float* coh,
                             const float* J, const long long* s1,
                             const long long* s2, float* out, float* cost,
                             float* tile_cost, unsigned* ticket, int T,
                             int nb, int K, int N, int V, int md,
                             const long long* vs, int C, const int* tb,
                             const int* wb)
{
    SweepArgs<ST> p = {static_cast<const ST*>(x), static_cast<const ST*>(w),
                       static_cast<const ST*>(cw), cid, coh, J, s1, s2, out,
                       cost, tile_cost, ticket, vs[0], vs[1], vs[2], vs[3],
                       vs[4], vs[5], T, nb, K, N};
    for (int r = 0; r <= C; ++r) {
        p.tb[r] = tb[r];
        p.wb[0][r] = wb[r];
        p.wb[1][r] = wb[SC_MAX_CLUSTER + 1 + r];
    }
    return md == 4 ? launch_md<4, ST>(cfg, p, V)
        : (md == 2 ? launch_md<2, ST>(cfg, p, V) : launch_md<1, ST>(cfg, p, V));
}

// One launch for V visits (V = 1: the single-visit sweep) at block width
// md (4 full, 2 diag, 1 phase) with the rows x, w, cw stored as st (0
// float, 1 bf16, 2 f16). The visit strides vs[6] are the elements
// between two visits of x, w, cw, the chunk ids, the coherencies and the
// Jones (floats), 0 for an operand that all visits share.
extern "C" int sweep_launch(const void* x, const void* w, const void* cw,
                            const long long* cid, const float* coh,
                            const float* J, const long long* s1,
                            const long long* s2, float* out, float* cost,
                            float* tile_cost, unsigned* ticket, int T,
                            int nb, int K, int N, int V, int md, int st,
                            const long long* vs, int C,
                            const int* tb, const int* wb, void* stream)
{
    if (K < 1 || K > SC_MAX_K || C < 1 || C > SC_MAX_CLUSTER || T < 1
        || nb < 1 || V < 1 || V > 65535 || (md != 4 && md != 2 && md != 1)
        || st < 0 || st > 2)
        return (int)cudaErrorInvalidValue;
    const int tiles = (nb + SC_TILE - 1) / SC_TILE;
    if (tiles > 65535) return (int)cudaErrorInvalidValue;
    const int rec = md == 4 ? Lay<4>::REC
        : (md == 2 ? Lay<2>::REC : Lay<1>::REC);
    // the geometry must cover every timeslot and every record word of a
    // tile once, in rank order
    bool ok = tb[0] == 0 && tb[C] == T;
    for (int last = 0; last < 2; ++last) {
        const int nbt = last ? nb - SC_TILE * (tiles - 1) : min(SC_TILE, nb);
        const int* wr = wb + last * (SC_MAX_CLUSTER + 1);
        ok = ok && wr[0] == 0 && wr[C] == K * nbt * rec;
        for (int r = 1; r <= C; ++r)
            ok = ok && tb[r - 1] <= tb[r] && wr[r - 1] <= wr[r];
    }
    if (!ok) return (int)cudaErrorInvalidValue;
    const cudaError_t err = cluster_smem_attr();
    if (err != cudaSuccess) return (int)err;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(C, V, tiles);
    cfg.blockDim = dim3(SC_THREADS, 1, 1);
    cfg.stream = (cudaStream_t)stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    cudaError_t e2;
    if (st == 0)
        e2 = launch_st<float>(&cfg, x, w, cw, cid, coh, J, s1, s2, out, cost,
                              tile_cost, ticket, T, nb, K, N, V, md, vs, C,
                              tb, wb);
    else if (st == 1)
        e2 = launch_st<__nv_bfloat16>(&cfg, x, w, cw, cid, coh, J, s1, s2,
                                      out, cost, tile_cost, ticket, T, nb, K,
                                      N, V, md, vs, C, tb, wb);
    else
        e2 = launch_st<__half>(&cfg, x, w, cw, cid, coh, J, s1, s2, out,
                               cost, tile_cost, ticket, T, nb, K, N, V, md,
                               vs, C, tb, wb);
    if (e2 != cudaSuccess) return (int)e2;
    return (int)cudaGetLastError();
}
