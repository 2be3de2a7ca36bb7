// Gauss-Newton blocks matvec on Hopper (CUDA C++, sm_90a), full-Jones
// mode (md = 4).
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
};

__device__ __forceinline__ float4 ld4(const float* p)
{
    return __ldg(reinterpret_cast<const float4*>(p));
}

__device__ __forceinline__ float dot4(const float4 a, const float4 b)
{
    return a.x * b.x + a.y * b.y + a.z * b.z + a.w * b.w;
}

__device__ __forceinline__ float comp(const float4 a, int j)
{
    return j == 0 ? a.x : (j == 1 ? a.y : (j == 2 ? a.z : a.w));
}

__global__ void __launch_bounds__(MV_THREADS)
matvec_station_kernel(const MatvecParams p, const float* __restrict__ v,
                      float* __restrict__ y)
{
    __shared__ float red[MV_WARPS][8];
    const int n = blockIdx.x, k = blockIdx.y;
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const unsigned full = 0xffffffffu;
    const float* vk = v + (size_t)k * p.N * 8;
    // lanes 8-23: row g of pq = [a][o][i][0..3]
    const int g = lane - 8;
    const int a = (g >> 3) & 1, o = (g >> 2) & 1, i = g & 3;
    const bool diag = lane < 8, cross = lane >= 8 && lane < 24;
    const float4 vown = diag ? ld4(vk + (size_t)n * 8 + (lane >> 2) * 4)
                             : make_float4(0.f, 0.f, 0.f, 0.f);
    float acc0 = 0.f;
    float4 acc1 = make_float4(0.f, 0.f, 0.f, 0.f);
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
        for (int j = 0; j < m; ++j) {
            const int en = __shfl_sync(full, my_ent, j);
            const int ot = __shfl_sync(full, my_oth, j);
            const size_t b = kb + (en >> 1);
            const bool side1 = en & 1;              // uniform over the warp
            const float* vo = vk + (size_t)ot * 8;
            if (diag) {
                const float* blk = side1 ? p.qq + b * p.sq : p.pp + b * p.sp;
                acc0 += dot4(ld4(blk + lane * 4), vown);
            } else if (cross) {
                const float4 m4 = ld4(p.pq + b * p.spq + g * 4);
                if (!side1) {
                    acc0 += dot4(m4, ld4(vo + o * 4));
                } else {
                    const float s = __ldg(vo + a * 4 + i);
                    acc1.x += m4.x * s;
                    acc1.y += m4.y * s;
                    acc1.z += m4.z * s;
                    acc1.w += m4.w * s;
                }
            }
        }
    }
    // each lane's share of the station's 8 outputs, then a fixed tree
    const int out0 = diag ? lane : (cross ? a * 4 + i : -1);
    float c[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
        c[q] = (q == out0) ? acc0 : 0.f;
        if (cross && (q >> 2) == o) c[q] += comp(acc1, q & 3);
    }
#pragma unroll
    for (int q = 0; q < 8; ++q)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            c[q] += __shfl_down_sync(full, c[q], off);
    if (lane == 0) {
#pragma unroll
        for (int q = 0; q < 8; ++q) red[warp][q] = c[q];
    }
    __syncthreads();
    if (threadIdx.x < 8) {
        const int q = threadIdx.x;
        float s = 0.f;
#pragma unroll
        for (int w = 0; w < MV_WARPS; ++w) s += red[w][q];
        const size_t at = ((size_t)k * p.N + n) * 8 + q;
        if (p.shift != nullptr) s += p.shift[k] * v[at];
        y[at] = s;
    }
}

extern "C" int matvec_launch(const MatvecParams* p, const float* v,
                             float* y, void* stream)
{
    if (p->K == 0 || p->N == 0) return 0;
    dim3 grid(p->N, p->K);
    matvec_station_kernel<<<grid, MV_THREADS, 0, (cudaStream_t)stream>>>(
        *p, v, y);
    return (int)cudaGetLastError();
}
