// Gauss-Newton blocks matvec on Hopper (CUDA C++, sm_90a), in each Jones
// mode: full (block width md = 4), diagonal (md = 2), phase-only (md = 1).
//
// Replaces the TPU kernel sagecal_tpu/ops/sweep_pallas.py:_matvec_kernel
// (launched by _matvec_blocks_jit, reached through gn_matvec_blocks). It
// computes y = (JTJ + shift I) v straight from the per-baseline Gram
// blocks the fused sweep emits, without forming JTJ: per (chunk k,
// baseline b) the 16x16 symmetric block [pp pq; pq^T qq] acts on the two
// stations' parameter vectors, and each station sums the products of
// its baselines.
//
//   yp[a][i] = sum_j pp[a][i][j] vp[a][j] + sum_{o,j} pq[a][o][i][j] vq[o][j]
//   yq[o][j] = sum_i qq[o][j][i] vq[o][i] + sum_{a,i} pq[a][o][i][j] vp[a][i]
//   y[k, n]  = sum over the baselines of station n of yp or yq
//              + shift[k] v[k, n]
//
// What bounds it on this card: latency, then launches. A product must
// read 128 block words per (chunk, baseline), v and the stations once
// and write y once, against 192 multiply-adds a (chunk, baseline): 3.9
// MB at K = 4, nb = 1891, N = 62 (1.17 us at 3.35 TB/s; 0.29 us at K =
// 1; chip_smoke.py's count), and in the tCG and PCG loops the blocks
// sit in L2, where the sweep just wrote them. So the time is the chain of dependent
// loads each warp waits on, one launch, and the host's call.
//
// Design (one launch, no scratch):
//  - one block of MV_WARPS warps per (station n, chunk k). The station's
//    entries in the CSR lists (ent [2 nb] with ent = 2 b + side, built
//    once per tile by the wrapper) are cut into MV_WARPS contiguous
//    runs, one per warp: the wrapper's runs [N, MV_WARPS, 2] (start, end)
//    (ops/sweep.py:matvec_runs, built with the lists), which the kernel
//    reads as they are;
//  - a warp loads the metadata of 32 entries at once (each lane one
//    entry and its other station), then walks them, broadcasting each
//    entry by shuffle; the record loads of successive entries do not
//    depend on each other, so several are in flight per lane;
//  - for one entry, lanes 0-7 each load one float4 row of the diagonal
//    block (pp on side 0, qq on side 1) and lanes 8-23 one float4 row of
//    pq: the 96 words the side needs in 24 16-byte loads of neighbouring
//    addresses. This needs every block row 16-byte aligned: the sweep
//    writes records of SW_REC = 160 words (640 bytes, 128-byte aligned),
//    and other layouts are copied once per plan by the wrapper;
//  - each lane keeps one scalar sum (out index fixed per lane) and, on
//    side 1, a float4 of pq^T products; at the end the lanes' shares are
//    reduced by a fixed shuffle tree, the warps' by a fixed sum in shared
//    memory, and shift[k] v[k, n] is added.
// No atomics and a fixed order: two calls on the same inputs give the
// same bits. The launch takes its fixed arguments from a MatvecParams
// record the wrapper fills once per Gram-block set (the "plan"), so a
// call passes only v, y and the stream.
//
// Measured (nvcc 12.8 -Xptxas -v, sm_90a): 40 registers, no spills; on
// an H100 80GB HBM3 ~6 us of device time a product at nb = 1891, N = 62
// (K = 1 and 4), against 7.3 us for the two kernels it replaces
// (tools_dev/torch_ab_kernels.py; PERF.md).
//
// Constrained Jones modes (--jones diag|phase; the TPU kernel reads md off
// its block shapes): md is a template parameter, and md = 4 keeps the
// kernel above (40 registers, its time within the spread of an A/B call
// against it, tools_dev/torch_ab_kernels.py). A (chunk, baseline) block
// then is [pp pq; pq^T qq] of 4 md x 4 md, 32 words of blocks a (chunk,
// baseline) at md = 2 and 8 at md = 1 against 128, so the bound falls
// with md while the chain of dependent loads does not. An entry needs
// 6 md lanes (2 md rows of the diagonal block, 4 md rows of pq), so a
// warp takes 24 / (6 md) entries at once: 1 at md = 4, 2 at md = 2, 4 at
// md = 1, which shortens each warp's chain by as much. A block row is md
// words, read with one load of its width (float4, float2, float): the
// sweep's records put every block on a multiple of md words (REC = 160,
// 44, 16 words), and the wrapper copies any other layout. The lanes'
// shares of the station's 2 md outputs are reduced by the same fixed
// tree: two calls on the same inputs give the same bits.

#include <cuda_runtime.h>

#define MV_WARPS 8
#define MV_THREADS (MV_WARPS * 32)

struct MatvecParams {
    const float* pp;       // [K, nb] records, sp words apart
    const float* qq;       // [K, nb] records, sq words apart
    const float* pq;       // [K, nb] records, spq words apart
    long long sp, sq, spq;
    const int* s1;         // [nb] stations of the baselines
    const int* s2;
    const int* runs;       // [N, MV_WARPS, 2] each warp's run of ent
    const int* ent;        // [2 nb]
    const float* shift;    // [K] or null
    int K, nb, N;
    int md;                // block width: 4 full, 2 diag, 1 phase
};

// md consecutive floats, read with one load of their width
template <int MD>
struct Row {
    float f[MD];
};

template <int MD>
__device__ __forceinline__ Row<MD> ldrow(const float* p)
{
    Row<MD> r;
    if constexpr (MD == 4) {
        const float4 t = __ldg(reinterpret_cast<const float4*>(p));
        r.f[0] = t.x; r.f[1] = t.y; r.f[2] = t.z; r.f[3] = t.w;
    } else if constexpr (MD == 2) {
        const float2 t = __ldg(reinterpret_cast<const float2*>(p));
        r.f[0] = t.x; r.f[1] = t.y;
    } else {
        r.f[0] = __ldg(p);
    }
    return r;
}

template <int MD>
__device__ __forceinline__ float dot(const Row<MD>& a, const Row<MD>& b)
{
    float s = a.f[0] * b.f[0];
#pragma unroll
    for (int j = 1; j < MD; ++j) s += a.f[j] * b.f[j];
    return s;
}

template <int MD>
__global__ void __launch_bounds__(MV_THREADS)
matvec_station_kernel(const MatvecParams p, const float* __restrict__ v,
                      float* __restrict__ y)
{
    constexpr int NV = 2 * MD;        // a station's parameters
    constexpr int SLOT = 6 * MD;      // lanes of one entry
    constexpr int E = 24 / SLOT;      // entries a warp takes at once
    constexpr int LOG = MD == 4 ? 2 : (MD == 2 ? 1 : 0);
    __shared__ float red[MV_WARPS][NV];
    const int n = blockIdx.x, k = blockIdx.y;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const unsigned full = 0xffffffffu;
    const float* vk = v + (size_t)k * p.N * NV;
    // the lane's entry slot and its place there: lanes 0 .. 2 md - 1 a
    // row of the diagonal block, the next 4 md a row g of pq = [a][o][i].
    // At md = 4 the slot is the lane itself, and the row index is split
    // with shifts and masks: the general division and modulo cost the
    // md = 4 kernel ~0.9 us a product on an H100.
    const int slot = E == 1 ? 0 : lane / SLOT;
    const int l = lane - slot * SLOT;
    const int g = l - NV;
    const int a = (g >> (LOG + 1)) & 1, o = (g >> LOG) & 1, i = g & (MD - 1);
    const bool diag = slot < E && l < NV;
    const bool cross = slot < E && l >= NV && l < SLOT;
    Row<MD> vown;
#pragma unroll
    for (int j = 0; j < MD; ++j) vown.f[j] = 0.f;
    if (diag) vown = ldrow<MD>(vk + (size_t)n * NV + (l >> LOG) * MD);
    float acc0 = 0.f;
    Row<MD> acc1;
#pragma unroll
    for (int j = 0; j < MD; ++j) acc1.f[j] = 0.f;
    const size_t kb = (size_t)k * p.nb;

    const int* run = p.runs + ((size_t)n * MV_WARPS + warp) * 2;
    const int w0 = run[0], w1 = run[1];
    for (int base = w0; base < w1; base += 32) {
        const int m = min(32, w1 - base);
        int my_ent = 0, my_oth = 0;
        if (lane < m) {
            my_ent = p.ent[base + lane];
            const int b = my_ent >> 1;
            my_oth = (my_ent & 1) ? p.s1[b] : p.s2[b];
        }
#pragma unroll 4
        for (int j0 = 0; j0 < m; j0 += E) {
            // slot s takes entry j0 + s
            const int j = E == 1 ? j0 : min(j0 + slot, 31);
            const int en = __shfl_sync(full, my_ent, j);
            const int ot = __shfl_sync(full, my_oth, j);
            if (E > 1 && j0 + slot >= m) continue;
            const size_t b = kb + (en >> 1);
            const bool side1 = en & 1;
            const float* vo = vk + (size_t)ot * NV;
            if (diag) {
                const float* blk = side1 ? p.qq + b * p.sq : p.pp + b * p.sp;
                acc0 += dot<MD>(ldrow<MD>(blk + l * MD), vown);
            } else if (cross) {
                const Row<MD> mr = ldrow<MD>(p.pq + b * p.spq + g * MD);
                if (!side1) {
                    acc0 += dot<MD>(mr, ldrow<MD>(vo + o * MD));
                } else {
                    const float s = __ldg(vo + a * MD + i);
#pragma unroll
                    for (int q = 0; q < MD; ++q) acc1.f[q] += mr.f[q] * s;
                }
            }
        }
    }
    // each lane's share of the station's NV outputs, then a fixed tree
    const int out0 = diag ? l : (cross ? a * MD + i : -1);
    float c[NV];
#pragma unroll
    for (int q = 0; q < NV; ++q) {
        c[q] = (q == out0) ? acc0 : 0.f;
        if (cross && (q / MD) == o) c[q] += acc1.f[q % MD];
    }
#pragma unroll
    for (int q = 0; q < NV; ++q)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            c[q] += __shfl_down_sync(full, c[q], off);
    if (lane == 0) {
#pragma unroll
        for (int q = 0; q < NV; ++q) red[warp][q] = c[q];
    }
    __syncthreads();
    if (threadIdx.x < NV) {
        const int q = threadIdx.x;
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < MV_WARPS; ++w) s += red[w][q];
        const size_t at = ((size_t)k * p.N + n) * NV + q;
        if (p.shift != nullptr) s += p.shift[k] * v[at];
        y[at] = s;
    }
}

extern "C" int matvec_launch(const MatvecParams* p, const float* v,
                             float* y, void* stream)
{
    if (p->K == 0 || p->N == 0) return 0;
    dim3 grid(p->N, p->K);
    cudaStream_t st = (cudaStream_t)stream;
    if (p->md == 4)
        matvec_station_kernel<4><<<grid, MV_THREADS, 0, st>>>(*p, v, y);
    else if (p->md == 2)
        matvec_station_kernel<2><<<grid, MV_THREADS, 0, st>>>(*p, v, y);
    else if (p->md == 1)
        matvec_station_kernel<1><<<grid, MV_THREADS, 0, st>>>(*p, v, y);
    else
        return (int)cudaErrorInvalidValue;
    return (int)cudaGetLastError();
}
