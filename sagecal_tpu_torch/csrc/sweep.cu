// Fused LM sweep on Hopper (CUDA C++, sm_90a), full-Jones mode (md = 4).
//
// Replaces the TPU kernel sagecal_tpu/ops/sweep_pallas.py:_sweep_kernel
// (maths in _sweep_body, launched by sweep_blocks). One pass over a
// cluster visit's rows per hybrid chunk k: model V = Jp C Jq^H, residual
// r = x - V, the Wirtinger factors of A = C Jq^H and Bm = Jp C, and per
// baseline the time-summed Gram blocks pp/qq [2,4,4], pq [2,2,4,4], the
// gradients jtep/jteq [2,4] and the acceptance cost sum (r cw)^2. The
// TPU kernel masks the rows of other chunks by folding (cid == k) into
// the weights; here a thread of chunk k skips them (same sums for
// finite data), so each row's payload is loaded and computed once over
// all chunks; only its chunk id is read by every chunk.
//
// What bounds it: bytes. A row is 33 words read once (x, w, cw 8 each,
// coherency 8, chunk id 1) against ~1200 float32 operations
// (SWEEP_FLOPS_PER_ROW in ops/sweep.py), so at the card's ratio of
// operations to bytes the row stream and the partial sums decide.
//
// Design. The TPU grid walks time sequentially and carries the sums in
// its output blocks; blocks on the card run in parallel, so:
//  - pass 1 (sweep_partials_kernel): one thread per (chunk k, baseline
//    b, time slice); it loops over its slice's rows and keeps the 121
//    distinct sums in registers (pp and qq are symmetric: 10 of 16
//    entries each), loading each 32-byte row field as two float4s
//    (rows are baseline-major [T, nb, 8], so neighbouring threads read
//    neighbouring rows). It writes its partials once, [slice, k, q, b].
//  - pass 2 (sweep_reduce_kernel): one thread per output element sums
//    the slices in a fixed order and writes the caller layout
//    [K, nb, 145] (pp 32, qq 32, pq 64, jtep 8, jteq 8, cost 1).
// No atomics, so the result is deterministic. The time axis is split
// into enough slices to fill the card (the wrapper picks the count).
//
// Second entry point: the multi-visit sweep. Replaces the TPU kernel
// sagecal_tpu/ops/sweep_pallas.py:_visits_kernel (launched by
// sweep_blocks_visits), which runs the same body for V stacked cluster
// visits in one grid. Each of x, w, cw, cid, coh and the Jones carries a
// visit stride, or a stride of 0 when one array is shared by all visits
// (the TPU kernel's static `batched` tuple). Bound by bytes like pass 1:
// 33 words a row when every operand is per visit, 17 when the weights
// are shared. The TPU kernel walks time outer so that a shared block is
// fetched once per time block; here visits_partials_kernel numbers its
// blocks with the visit fastest, then the chunk, then the baseline block,
// so the V visits (and K chunks) of one (baseline block, time slice) run
// as neighbouring blocks: a shared row is read once from memory and
// served to the others from L2. Its partials [nsl, V K, 121, nb] go
// through the same fixed-order sweep_reduce_kernel, into one [V K, nb,
// 145] buffer whose visits fold into the chunk axis for the caller.

#include <cuda_runtime.h>

#define SW_THREADS 128
#define SW_NACC 121
#define SW_NOUT 145
#define Q_PP 0
#define Q_QQ 20
#define Q_PQ 40
#define Q_JP 104
#define Q_JQ 112
#define Q_COST 120

// index of (i, j), i <= j, in the packed upper triangle of a 4x4 block
__host__ __device__ __forceinline__ int sym_pair(int i, int j)
{
    return i * 4 - (i * (i - 1)) / 2 + (j - i);
}

__device__ __forceinline__ void load8(const float* p, float* v)
{
    const float4 a = reinterpret_cast<const float4*>(p)[0];
    const float4 b = reinterpret_cast<const float4*>(p)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// the sums of one (chunk k, baseline b) over rows t0 <= t < t1 of a
// visit: P, Q the chunk's Jones of the baseline's two stations, entries
// e = row * 2 + col (row-major), (re, im)
__device__ __forceinline__ void sweep_rows(const float* __restrict__ x,
                                           const float* __restrict__ w,
                                           const float* __restrict__ cw,
                                           const int* __restrict__ cid,
                                           const float* __restrict__ coh,
                                           const float* P, const float* Q,
                                           int nb, int K, int k, int b,
                                           int t0, int t1, float* acc)
{
    for (int t = t0; t < t1; ++t) {
        const size_t row = (size_t)t * nb + b;
        // rows of other chunks carry zero weight: skip them outright
        // (the chunk id is per timeslot, so the branch is warp-uniform)
        if (K > 1 && cid[row] != k) continue;
        float xv[8], wv[8], cwv[8], cv[8];
        load8(x + row * 8, xv);
        load8(w + row * 8, wv);
        load8(cw + row * 8, cwv);
        load8(coh + row * 8, cv);
        // A = C Jq^H, Bm = Jp C, V = Jp A: [a][o] (re, im)
        float Ar[2][2], Ai[2][2], Br[2][2], Bi[2][2], Vr[2][2], Vi[2][2];
#pragma unroll
        for (int a = 0; a < 2; ++a) {
#pragma unroll
            for (int o = 0; o < 2; ++o) {
                float zr = 0.f, zi = 0.f, yr_, yi_;
#pragma unroll
                for (int d = 0; d < 2; ++d) {
                    const float xr = cv[(a * 2 + d) * 2];
                    const float xi = cv[(a * 2 + d) * 2 + 1];
                    yr_ = Q[(o * 2 + d) * 2];
                    yi_ = -Q[(o * 2 + d) * 2 + 1];
                    zr += xr * yr_ - xi * yi_;
                    zi += xr * yi_ + xi * yr_;
                }
                Ar[a][o] = zr;
                Ai[a][o] = zi;
                zr = 0.f;
                zi = 0.f;
#pragma unroll
                for (int d = 0; d < 2; ++d) {
                    const float xr = P[(a * 2 + d) * 2];
                    const float xi = P[(a * 2 + d) * 2 + 1];
                    const float cr = cv[(d * 2 + o) * 2];
                    const float ci = cv[(d * 2 + o) * 2 + 1];
                    zr += xr * cr - xi * ci;
                    zi += xr * ci + xi * cr;
                }
                Br[a][o] = zr;
                Bi[a][o] = zi;
            }
        }
#pragma unroll
        for (int a = 0; a < 2; ++a) {
#pragma unroll
            for (int o = 0; o < 2; ++o) {
                float zr = 0.f, zi = 0.f;
#pragma unroll
                for (int d = 0; d < 2; ++d) {
                    const float xr = P[(a * 2 + d) * 2];
                    const float xi = P[(a * 2 + d) * 2 + 1];
                    zr += xr * Ar[d][o] - xi * Ai[d][o];
                    zi += xr * Ai[d][o] + xi * Ar[d][o];
                }
                Vr[a][o] = zr;
                Vi[a][o] = zi;
            }
        }
        // residual, squared weights and the acceptance cost;
        // component c = (a * 2 + o) * 2 + ri
        float w2[8], rw2[8];
#pragma unroll
        for (int c = 0; c < 8; ++c) {
            const int a = c >> 2, o = (c >> 1) & 1, ri = c & 1;
            const float r = xv[c] - (ri == 0 ? Vr[a][o] : Vi[a][o]);
            w2[c] = wv[c] * wv[c];
            rw2[c] = r * w2[c];
            const float rc = r * cwv[c];
            acc[Q_COST] += rc * rc;
        }
        // Wirtinger factors (normal_eq._ma_factor / _mb_factor):
        // fa[o][ri][m], fb[a][ri][m] with m = d * 2 + ci
        float fa[2][2][4], fb[2][2][4];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
#pragma unroll
            for (int d = 0; d < 2; ++d) {
                fa[s][0][d * 2] = Ar[d][s];
                fa[s][0][d * 2 + 1] = -Ai[d][s];
                fa[s][1][d * 2] = Ai[d][s];
                fa[s][1][d * 2 + 1] = Ar[d][s];
                fb[s][0][d * 2] = Br[s][d];
                fb[s][0][d * 2 + 1] = Bi[s][d];
                fb[s][1][d * 2] = Bi[s][d];
                fb[s][1][d * 2 + 1] = -Br[s][d];
            }
        }
        // Gram blocks and gradients
#pragma unroll
        for (int a = 0; a < 2; ++a) {
#pragma unroll
            for (int o = 0; o < 2; ++o) {
#pragma unroll
                for (int ri = 0; ri < 2; ++ri) {
                    const int c = (a * 2 + o) * 2 + ri;
                    const float ww = w2[c];
#pragma unroll
                    for (int i = 0; i < 4; ++i) {
                        const float wa = ww * fa[o][ri][i];
                        const float wb = ww * fb[a][ri][i];
#pragma unroll
                        for (int j = i; j < 4; ++j) {
                            acc[Q_PP + a * 10 + sym_pair(i, j)] +=
                                wa * fa[o][ri][j];
                            acc[Q_QQ + o * 10 + sym_pair(i, j)] +=
                                wb * fb[a][ri][j];
                        }
#pragma unroll
                        for (int j = 0; j < 4; ++j)
                            acc[Q_PQ + ((a * 2 + o) * 4 + i) * 4 + j] +=
                                wa * fb[a][ri][j];
                        acc[Q_JP + a * 4 + i] += rw2[c] * fa[o][ri][i];
                        acc[Q_JQ + o * 4 + i] += rw2[c] * fb[a][ri][i];
                    }
                }
            }
        }
    }
}

__global__ void __launch_bounds__(SW_THREADS)
sweep_partials_kernel(const float* __restrict__ x,    // [T*nb, 8]
                      const float* __restrict__ w,    // [T*nb, 8]
                      const float* __restrict__ cw,   // [T*nb, 8]
                      const int* __restrict__ cid,    // [T*nb]
                      const float* __restrict__ coh,  // [T*nb, 2, 2, re/im]
                      const float* __restrict__ jp,   // [K, nb, 2, 2, re/im]
                      const float* __restrict__ jq,   // [K, nb, 2, 2, re/im]
                      float* __restrict__ part,       // [nsl, K, 121, nb]
                      int T, int nb, int K, int tl)
{
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    const int k = blockIdx.y;
    const int sl = blockIdx.z;
    if (b >= nb) return;

    float P[8], Q[8];
    load8(jp + ((size_t)k * nb + b) * 8, P);
    load8(jq + ((size_t)k * nb + b) * 8, Q);

    float acc[SW_NACC];
#pragma unroll
    for (int q = 0; q < SW_NACC; ++q) acc[q] = 0.f;

    const int t0 = sl * tl;
    sweep_rows(x, w, cw, cid, coh, P, Q, nb, K, k, b, t0, min(T, t0 + tl),
               acc);
    float* dst = part + ((size_t)sl * K + k) * SW_NACC * nb + b;
#pragma unroll
    for (int q = 0; q < SW_NACC; ++q) dst[(size_t)q * nb] = acc[q];
}

__global__ void __launch_bounds__(SW_THREADS)
visits_partials_kernel(const float* __restrict__ x,   // [(V,) T*nb, 8]
                       const float* __restrict__ w,   // [(V,) T*nb, 8]
                       const float* __restrict__ cw,  // [(V,) T*nb, 8]
                       const int* __restrict__ cid,   // [(V,) T*nb]
                       const float* __restrict__ coh, // [(V,) T*nb, 8]
                       const float* __restrict__ jp,  // [(V,) K, nb, 8]
                       const float* __restrict__ jq,  // [(V,) K, nb, 8]
                       float* __restrict__ part,      // [nsl, V*K, 121, nb]
                       int T, int nb, int K, int V, int tl,
                       long long sx, long long sw, long long scw,
                       long long scid, long long scoh, long long sj)
{
    // block x = ((baseline block * K) + k) * V + v: visits fastest
    int bx = blockIdx.x;
    const int v = bx % V;
    bx /= V;
    const int k = bx % K;
    const int b = (bx / K) * blockDim.x + threadIdx.x;
    const int sl = blockIdx.y;
    if (b >= nb) return;

    float P[8], Q[8];
    load8(jp + v * sj + ((size_t)k * nb + b) * 8, P);
    load8(jq + v * sj + ((size_t)k * nb + b) * 8, Q);

    float acc[SW_NACC];
#pragma unroll
    for (int q = 0; q < SW_NACC; ++q) acc[q] = 0.f;

    const int t0 = sl * tl;
    sweep_rows(x + v * sx, w + v * sw, cw + v * scw, cid + v * scid,
               coh + v * scoh, P, Q, nb, K, k, b, t0, min(T, t0 + tl), acc);
    float* dst = part + ((size_t)sl * V * K + (size_t)v * K + k) * SW_NACC
        * nb + b;
#pragma unroll
    for (int q = 0; q < SW_NACC; ++q) dst[(size_t)q * nb] = acc[q];
}

// output element e of the [145] caller layout -> partial-sum index q
__device__ __forceinline__ int out_to_acc(int e)
{
    if (e < 64) {                       // pp (e < 32) or qq
        const int base = e < 32 ? Q_PP : Q_QQ;
        const int r = e & 31;
        const int s = r >> 4, i = (r >> 2) & 3, j = r & 3;
        return base + s * 10 + (i <= j ? sym_pair(i, j) : sym_pair(j, i));
    }
    if (e < 128) return Q_PQ + (e - 64);
    if (e < 136) return Q_JP + (e - 128);
    if (e < 144) return Q_JQ + (e - 136);
    return Q_COST;
}

__global__ void sweep_reduce_kernel(const float* __restrict__ part,
                                    float* __restrict__ out,  // [K, nb, 145]
                                    int nb, int K, int nsl)
{
    const size_t idx = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
    const size_t total = (size_t)K * SW_NOUT * nb;
    if (idx >= total) return;
    const int b = (int)(idx % nb);
    const int e = (int)((idx / nb) % SW_NOUT);
    const int k = (int)(idx / ((size_t)nb * SW_NOUT));
    const int q = out_to_acc(e);
    float s = 0.f;
    for (int sl = 0; sl < nsl; ++sl)
        s += part[(((size_t)sl * K + k) * SW_NACC + q) * nb + b];
    out[((size_t)k * nb + b) * SW_NOUT + e] = s;
}

extern "C" int sweep_partials_launch(const float* x, const float* w,
                                     const float* cw, const int* cid,
                                     const float* coh, const float* jp,
                                     const float* jq, float* part, int T,
                                     int nb, int K, int nsl, int tl,
                                     void* stream)
{
    if (nb == 0 || K == 0 || nsl == 0) return 0;
    dim3 grid((nb + SW_THREADS - 1) / SW_THREADS, K, nsl);
    sweep_partials_kernel<<<grid, SW_THREADS, 0, (cudaStream_t)stream>>>(
        x, w, cw, cid, coh, jp, jq, part, T, nb, K, tl);
    return (int)cudaGetLastError();
}

extern "C" int sweep_reduce_launch(const float* part, float* out, int nb,
                                   int K, int nsl, void* stream)
{
    const size_t total = (size_t)K * SW_NOUT * nb;
    if (total == 0) return 0;
    const int threads = 256;
    const unsigned blocks = (unsigned)((total + threads - 1) / threads);
    sweep_reduce_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        part, out, nb, K, nsl);
    return (int)cudaGetLastError();
}

extern "C" int visits_partials_launch(const float* x, const float* w,
                                      const float* cw, const int* cid,
                                      const float* coh, const float* jp,
                                      const float* jq, float* part, int T,
                                      int nb, int K, int V, int nsl, int tl,
                                      long long sx, long long sw,
                                      long long scw, long long scid,
                                      long long scoh, long long sj,
                                      void* stream)
{
    if (nb == 0 || K == 0 || V == 0 || nsl == 0) return 0;
    const unsigned nbb = (unsigned)((nb + SW_THREADS - 1) / SW_THREADS);
    dim3 grid(nbb * (unsigned)K * (unsigned)V, nsl);
    visits_partials_kernel<<<grid, SW_THREADS, 0, (cudaStream_t)stream>>>(
        x, w, cw, cid, coh, jp, jq, part, T, nb, K, V, tl, sx, sw, scw,
        scid, scoh, sj);
    return (int)cudaGetLastError();
}
