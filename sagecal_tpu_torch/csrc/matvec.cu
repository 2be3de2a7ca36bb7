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
// What bounds it: bytes. A (chunk, baseline) reads 128 block words and
// 16 words of v against 192 multiply-adds, so one product moves about
// K nb 576 bytes (4.4 MB at K = 4, nb = 1891: ~1.3 us at 3.35 TB/s)
// and the two launches, not the arithmetic, set its time at the
// calibration shapes.
//
// Design. The TPU wrapper gathers v per baseline and scatters y per
// station outside its kernel (XLA gathers and a scatter-add). Here:
//  - pass 1 (matvec_blocks_kernel): one thread per (k, b) reads
//    vp = v[k, s1[b]] and vq = v[k, s2[b]] through the station indices
//    (the gather is fused), applies the block and writes yp, yq to a
//    [K, nb, 2, 8] scratch. The blocks may be strided views of the
//    sweep's [K, nb, 145] output (one stride per block kind), so no
//    copy is made between the sweep and the matvec.
//  - pass 2 (matvec_gather_kernel): one warp per (k, station n) walks
//    the station's list of (baseline, side) entries, built once per
//    station layout by the wrapper (CSR: ptr [N + 1], ent [2 nb] with
//    ent = 2 b + side, in ascending order), accumulates 8 sums per lane
//    and reduces them over the warp by a fixed shuffle tree, then adds
//    shift[k] v[k, n].
// No atomics: the result is deterministic, as in the sweep's reduce.

#include <cuda_runtime.h>

#define MV_THREADS 128

__global__ void __launch_bounds__(MV_THREADS)
matvec_blocks_kernel(const float* __restrict__ pp,  // [K, nb] x sp words
                     const float* __restrict__ qq,  // [K, nb] x sq words
                     const float* __restrict__ pq,  // [K, nb] x spq words
                     long long sp, long long sq, long long spq,
                     const float* __restrict__ v,   // [K, N, 2, 4]
                     const int* __restrict__ s1,    // [nb]
                     const int* __restrict__ s2,    // [nb]
                     float* __restrict__ yb,        // [K, nb, 2, 8]
                     int nb, int N)
{
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    const int k = blockIdx.y;
    if (b >= nb) return;
    const size_t kb = (size_t)k * nb + b;
    const float* P = pp + kb * sp;      // [a][i][j]
    const float* Q = qq + kb * sq;      // [o][j][i]
    const float* X = pq + kb * spq;     // [a][o][i][j]
    const float* vpp = v + ((size_t)k * N + s1[b]) * 8;
    const float* vqp = v + ((size_t)k * N + s2[b]) * 8;
    float vp[8], vq[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) {
        vp[c] = vpp[c];
        vq[c] = vqp[c];
    }
    float y[16];
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
            float acc = 0.f;
#pragma unroll
            for (int j = 0; j < 4; ++j)
                acc += P[(a * 4 + i) * 4 + j] * vp[a * 4 + j];
#pragma unroll
            for (int o = 0; o < 2; ++o)
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    acc += X[((a * 2 + o) * 4 + i) * 4 + j] * vq[o * 4 + j];
            y[a * 4 + i] = acc;
        }
    }
#pragma unroll
    for (int o = 0; o < 2; ++o) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            float acc = 0.f;
#pragma unroll
            for (int i = 0; i < 4; ++i)
                acc += Q[(o * 4 + j) * 4 + i] * vq[o * 4 + i];
#pragma unroll
            for (int a = 0; a < 2; ++a)
#pragma unroll
                for (int i = 0; i < 4; ++i)
                    acc += X[((a * 2 + o) * 4 + i) * 4 + j] * vp[a * 4 + i];
            y[8 + o * 4 + j] = acc;
        }
    }
    float4* dst = reinterpret_cast<float4*>(yb + kb * 16);
#pragma unroll
    for (int c = 0; c < 4; ++c)
        dst[c] = make_float4(y[4 * c], y[4 * c + 1], y[4 * c + 2],
                             y[4 * c + 3]);
}

__global__ void __launch_bounds__(MV_THREADS)
matvec_gather_kernel(const float* __restrict__ yb,     // [K, nb, 2, 8]
                     const int* __restrict__ ptr,      // [N + 1]
                     const int* __restrict__ ent,      // [2 nb]
                     const float* __restrict__ v,      // [K, N, 8]
                     const float* __restrict__ shift,  // [K] or null
                     float* __restrict__ y,            // [K, N, 8]
                     int K, int nb, int N)
{
    const int warp = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
    const int lane = threadIdx.x & 31;
    if (warp >= K * N) return;          // uniform over the warp
    const int k = warp / N;
    const int n = warp - k * N;
    float acc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] = 0.f;
    const float* ybk = yb + (size_t)k * nb * 16;
    const int e1 = ptr[n + 1];
    for (int e = ptr[n] + lane; e < e1; e += 32) {
        const float4* src =
            reinterpret_cast<const float4*>(ybk + (size_t)ent[e] * 8);
        const float4 lo = src[0];
        const float4 hi = src[1];
        acc[0] += lo.x; acc[1] += lo.y; acc[2] += lo.z; acc[3] += lo.w;
        acc[4] += hi.x; acc[5] += hi.y; acc[6] += hi.z; acc[7] += hi.w;
    }
#pragma unroll
    for (int c = 0; c < 8; ++c)
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            acc[c] += __shfl_down_sync(0xffffffffu, acc[c], off);
    if (lane == 0) {
        const size_t o = ((size_t)k * N + n) * 8;
        if (shift != nullptr) {
            const float sh = shift[k];
#pragma unroll
            for (int c = 0; c < 8; ++c) y[o + c] = acc[c] + sh * v[o + c];
        } else {
#pragma unroll
            for (int c = 0; c < 8; ++c) y[o + c] = acc[c];
        }
    }
}

extern "C" int matvec_launch(const float* pp, const float* qq,
                             const float* pq, long long sp, long long sq,
                             long long spq, const float* v, const int* s1,
                             const int* s2, const int* ptr, const int* ent,
                             const float* shift, float* yb, float* y, int K,
                             int nb, int N, void* stream)
{
    if (K == 0 || N == 0) return 0;
    cudaStream_t st = (cudaStream_t)stream;
    if (nb > 0) {
        dim3 grid((nb + MV_THREADS - 1) / MV_THREADS, K);
        matvec_blocks_kernel<<<grid, MV_THREADS, 0, st>>>(
            pp, qq, pq, sp, sq, spq, v, s1, s2, yb, nb, N);
        const cudaError_t err = cudaGetLastError();
        if (err != cudaSuccess) return (int)err;
    }
    const long long threads = (long long)K * N * 32;
    const unsigned blocks =
        (unsigned)((threads + MV_THREADS - 1) / MV_THREADS);
    matvec_gather_kernel<<<blocks, MV_THREADS, 0, st>>>(
        yb, ptr, ent, v, shift, y, K, nb, N);
    return (int)cudaGetLastError();
}
