// Point/gaussian-source coherencies on Hopper (CUDA C++, sm_90a).
//
// Replaces the TPU kernel sagecal_tpu/ops/coh_pallas.py:_coh_kernel
// (reached through coherencies_points). For every (cluster m, channel f,
// row b) it sums over the cluster's sources s:
//   G = 2 pi (l u + m v + n w), phase = G f,
//   smear = |sin(G fdelta/2) / (G fdelta/2)| (1 at G = 0),
//   gaussian envelope pi/2 exp(-f^2 q), q = (g1 up + g2 vp)^2
//   + (g3 up + g4 vp)^2 with (up, vp) the source's projection of (u, v, w),
// into the Stokes-weighted correlations XX, XY, YX, YY (re, im).
//
// What bounds it: instruction issue. The bytes are O(M F B) out and
// O(B + M F S) in; the work is O(M F B S) terms, and the function's own
// count is 29 operations a term plus 10 per (m, b, s) (ops/coh.py,
// COH_OPS_*), which the FMA pipe alone could issue in 0.45 ms at F = 8
// on chip_smoke's shapes. The first design (one thread per (m, f, b))
// redid the geometry, the |sinc| (a full-range sinf and an IEEE
// division), the gaussian projection and a full-range sincosf for every
// channel; sincosf and sinf alone carry their range reduction, integer
// and subnormal cases on the conversion pipe. It ran at 12% of that
// bound at F = 8.
//
// The design:
// - One thread owns a row b of cluster m across a tile of up to FT
//   channels (FT = 1 for a single channel, else 8 with the slots past a
//   tile's channels idle; the tile and grid come from
//   ops/coh.py:coh_geometry). Per (m, b, s) it computes once: the fringe
//   rate G' = l u + m v + n w in turns per Hz, the |sinc|, the gaussian's
//   q, and it reads the source's staged float4 records once. Per channel
//   it does only the phasor, the envelope's exp2 (gaussians only) and the
//   sums.
// - Cheaper phasors without a less accurate phase: sincospi_red takes
//   the phase in half turns as the exact product G' (2 f) and reduces it
//   with one fmaf, so the product is never rounded (the phase error is
//   that of G' alone, below the float32 plain version's); its minimax
//   polynomials need no conversion instruction and no special case.
//   No __sinf/__cosf and no --use_fast_math: the phase reaches 1e3..1e4
//   rad. Where the host found the channels evenly spaced (ops/coh.py:
//   channel_step; RECUR), the tile's first channel and the step take one
//   sincospi_red each, and each next channel is the angle-addition
//   rotation e^{i G f_k} = e^{i G f_{k-1}} e^{i G df}: 4 FMA-pipe
//   instructions instead of a sincos. A tile restarts the recurrence, so
//   at most 7 rotations accumulate roundoff (~1e-7 rad each).
// - The eight sums are kept as XX, YY and the four products
//   P = sum wU C, Q = sum wV S, R = sum wU S, T = sum wV C (8 FMAs a
//   term); XY = (P - Q, R + T) and YX = (P + Q, R - T) are formed once at
//   the end. 8 FT accumulators live in registers (64 at FT = 8; 127
//   registers, 2 blocks of 256 threads an SM).
// - Sources are staged in shared memory as float4 records, COH_SRC_CHUNK
//   at a time: (l, m, n, is-gaussian), three of projection and shape
//   coefficients, and one (I+Q, I-Q, U, V) per channel of the tile. Every
//   thread of a block reads the same record (a broadcast).
// - Issued instructions per term (tools_dev/torch_coh_sass.py, the source
//   loop of the SASS): one point / gaussian source's path through the
//   loop, picked from the code's shape (a heuristic), is 21.3 / 27.9 at
//   FT = 8 with the recurrence, 31.4 / 36.3 at FT = 8 by per-channel
//   sincos and 61 / 79 at FT = 1, against 119 / 155 for the first design
//   (its never-taken slow-path range reductions skipped). With no path
//   picked, the loop body holds 360 / 508 / 108 instructions, against
//   396 for the first design's one channel. What is left at FT = 8 is
//   latency: 16 warps an SM issue about 2/3 of the lanes' peak rate at
//   1.98 GHz, where FT = 1 (40 warps) issues 85% (PERF.md).
// - The output is written once, 32 bytes per (row, channel), in the
//   [M, B, F, 8] layout viewed as complex by the callers. The kernel
//   masks the ragged row tail itself (the TPU version pads B). Each
//   thread sums its sources in a fixed order: repeat calls are bitwise
//   equal.

#include <cuda_runtime.h>

#define COH_THREADS 256
#define COH_SRC_CHUNK 128
// 1.5 2^23: x + COH_MAGIC rounds x to an integer, left in the low mantissa
// bits of the sum (exact for |x| < 2^22)
#define COH_MAGIC 12582912.0f

struct CohArgs {
    const float* uvw3;   // [3, B]
    const float* geom;   // [M, 3, S]
    const float* flux;   // [M, F, 4, S]
    const float* gauss;  // [M, 11, S]
    const float* freqs;  // [F]
    float* out;          // [M, B, F, 8]
    float fdelta;        // smearing bandwidth per channel
    float step;          // channel spacing (RECUR only)
    int M, F, B, S;
    int tile;            // channels per tile (<= FT)
};

// sin(pi x) and cos(pi x) of the exact product x = a b (a phase in half
// turns, |x| < 2^22: up to 1.3e7 rad, where a float32 phase has no digit
// left anyway), each up to the sign (-1)^j returned for the caller to fold
// into a scale: j = rint(x) by the COH_MAGIC rounding, r = x - j from one
// fmaf (the product is never rounded, |r| <= 1/2), and minimax polynomials
// in r^2 of sin(pi r) (degree 9) and cos(pi r) (degree 10) on [-1/2, 1/2],
// within 1.6e-7. No conversion instruction, no special cases.
__device__ __forceinline__ float sincospi_red(float a, float b, float& s,
                                              float& c)
{
    const float y = fmaf(a, b, COH_MAGIC);
    const float r = fmaf(a, b, -(y - COH_MAGIC));
    const float u = r * r;
    s = r * fmaf(fmaf(fmaf(fmaf(0.07765940576791763f, u,
                                -0.5982921719551086f), u,
                           2.5500776767730713f), u,
                      -5.167710304260254f), u, 3.1415927410125732f);
    c = fmaf(fmaf(fmaf(fmaf(fmaf(-0.024396715685725212f, u,
                                 0.23493756353855133f), u,
                            -1.3352121114730835f), u,
                       4.058709144592285f), u,
                  -4.934802055358887f), u, 1.f);
    return __int_as_float((__float_as_int(y) << 31) | 0x3f800000);
}

// 2^x (the hardware approximation, relative error < 2^-22; results below
// 2^-126 flush to 0)
__device__ __forceinline__ float ex2_ftz(float x)
{
    float y;
    asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
    return y;
}

// One source's contribution to the FT channels of a row: ``GAUSS`` the
// envelope per channel, ``RECUR`` the phasor by rotation.
template <int FT, bool RECUR, bool GAUSS>
__device__ __forceinline__ void add_source(
    float (&acc)[FT][8], const float4 (*sw)[COH_SRC_CHUNK], int s,
    float Gp, float scale, float q, const float (&two_f)[FT],
    const float (&ex2)[FT], float two_step)
{
    float sn, cs, sd = 0.f, cd = 1.f;
    if (RECUR) {
        scale *= sincospi_red(Gp, two_f[0], sn, cs);
        const float sg = sincospi_red(Gp, two_step, sd, cd);
        sd *= sg;
        cd *= sg;
        if (!GAUSS) {
            cs *= scale;
            sn *= scale;
        }
    }
    // every one of the FT channels, branch free (a tile's channels past
    // its count nf read zero weights and are never stored)
#pragma unroll
    for (int k = 0; k < FT; ++k) {
        float e = scale;
        if (!RECUR) e *= sincospi_red(Gp, two_f[k], sn, cs);
        if (GAUSS) e *= ex2_ftz(ex2[k] * q);
        float C = cs, Sn = sn;
        if (GAUSS || !RECUR) {
            C *= e;
            Sn *= e;
        }
        const float4 wt = sw[k][s];   // I+Q, I-Q, U, V
        acc[k][0] = fmaf(wt.x, C, acc[k][0]);
        acc[k][1] = fmaf(wt.x, Sn, acc[k][1]);
        acc[k][2] = fmaf(wt.z, C, acc[k][2]);    // P
        acc[k][3] = fmaf(wt.w, Sn, acc[k][3]);   // Q
        acc[k][4] = fmaf(wt.z, Sn, acc[k][4]);   // R
        acc[k][5] = fmaf(wt.w, C, acc[k][5]);    // T
        acc[k][6] = fmaf(wt.y, C, acc[k][6]);
        acc[k][7] = fmaf(wt.y, Sn, acc[k][7]);
        if (RECUR && k + 1 < FT) {
            const float c2 = fmaf(cs, cd, -sn * sd);
            sn = fmaf(sn, cd, cs * sd);
            cs = c2;
        }
    }
}

template <int FT, bool RECUR>
__global__ void __launch_bounds__(COH_THREADS, FT >= 8 ? 2 : 3)
coh_points_kernel(const CohArgs a)
{
    // record 0: (l, m, n, is-gaussian); 1-3: projection pu1 pu2 pu3 pv1,
    // pv2 pv3 g1 g2, g3 g4; 4 + k: channel k's (I+Q, I-Q, U, V)
    __shared__ float4 sh[4 + FT][COH_SRC_CHUNK];
    const float PI = 3.14159265358979f;
    const float HALF_PI = 1.5707963267948966f;
    const float LOG2E = 1.4426950408889634f;
    const int m = blockIdx.z;
    const int f0 = blockIdx.y * a.tile;
    const int nf = min(a.tile, a.F - f0);
    const int b = blockIdx.x * COH_THREADS + threadIdx.x;
    const int S = a.S;
    const bool live = b < a.B;
    float u = 0.f, v = 0.f, w = 0.f;
    if (live) {
        u = a.uvw3[b];
        v = a.uvw3[a.B + b];
        w = a.uvw3[2 * a.B + b];
    }
    // 2 f_k (the phase in half turns) and -f_k^2 log2(e) (the envelope)
    float two_f[FT], ex2[FT];
#pragma unroll
    for (int k = 0; k < FT; ++k) {
        const float fk = a.freqs[f0 + min(k, nf - 1)];
        two_f[k] = 2.f * fk;
        ex2[k] = -(fk * fk) * LOG2E;
    }
    const float two_step = 2.f * a.step;
    float acc[FT][8];
#pragma unroll
    for (int k = 0; k < FT; ++k)
#pragma unroll
        for (int c = 0; c < 8; ++c) acc[k][c] = 0.f;

    const size_t gm = (size_t)m * 11 * S;
    for (int s0 = 0; s0 < S; s0 += COH_SRC_CHUNK) {
        const int ns = min(COH_SRC_CHUNK, S - s0);
        for (int idx = threadIdx.x; idx < (4 + FT) * ns; idx += COH_THREADS) {
            const int r = idx / ns;
            const int s = idx - r * ns;
            const int sg = s0 + s;
            float4 val;
            if (r == 0) {
                const float* g = a.geom + (size_t)m * 3 * S + sg;
                val = make_float4(g[0], g[S], g[2 * S],
                                  a.gauss[gm + 10 * S + sg]);
            } else if (r < 4) {
                const float* g = a.gauss + gm + (size_t)(4 * (r - 1)) * S + sg;
                val = make_float4(g[0], g[S], r < 3 ? g[2 * S] : 0.f,
                                  r < 3 ? g[3 * S] : 0.f);
            } else if (r < 4 + nf) {
                const float* fl = a.flux
                    + ((size_t)m * a.F + f0 + r - 4) * 4 * S + sg;
                val = make_float4(fl[0], fl[S], fl[2 * S], fl[3 * S]);
            } else {
                val = make_float4(0.f, 0.f, 0.f, 0.f);
            }
            sh[r][s] = val;
        }
        __syncthreads();
        if (live) {
            for (int s = 0; s < ns; ++s) {
                const float4 g = sh[0][s];
                // fringe rate in turns per Hz: phase = 2 pi Gp f
                const float Gp = fmaf(g.x, u, fmaf(g.y, v, g.z * w));
                // |sin(x)/x|, x = pi Gp fdelta (the sign of sin drops out)
                const float xpi = PI * (Gp * a.fdelta);
                float sx, cx;
                sincospi_red(Gp, a.fdelta, sx, cx);
                const float sinc = fabsf(__fdividef(sx, xpi));
                const float scale = fabsf(xpi) > 1e-30f ? sinc : 1.0f;
                if (g.w > 0.f) {
                    const float4 p0 = sh[1][s], p1 = sh[2][s], p2 = sh[3][s];
                    const float up = fmaf(p0.x, u, fmaf(p0.y, v, p0.z * w));
                    const float vp = fmaf(p0.w, u, fmaf(p1.x, v, p1.y * w));
                    const float ut = fmaf(p1.z, up, p1.w * vp);
                    const float vt = fmaf(p2.x, up, p2.y * vp);
                    const float q = fmaf(ut, ut, vt * vt);
                    add_source<FT, RECUR, true>(acc, sh + 4, s, Gp,
                                                scale * HALF_PI, q, two_f,
                                                ex2, two_step);
                } else {
                    add_source<FT, RECUR, false>(acc, sh + 4, s, Gp,
                                                 scale, 0.f, two_f, ex2,
                                                 two_step);
                }
            }
        }
        __syncthreads();
    }
    if (live) {
#pragma unroll
        for (int k = 0; k < FT; ++k) {
            if (k < nf) {
                float4* o = reinterpret_cast<float4*>(
                    a.out + (((size_t)m * a.B + b) * a.F + f0 + k) * 8);
                const float P = acc[k][2], Q = acc[k][3];
                const float R = acc[k][4], T = acc[k][5];
                o[0] = make_float4(acc[k][0], acc[k][1], P - Q, R + T);
                o[1] = make_float4(P + Q, R - T, acc[k][6], acc[k][7]);
            }
        }
    }
}

template <int FT, bool RECUR>
static void launch(const CohArgs& a, dim3 grid, cudaStream_t stream)
{
    coh_points_kernel<FT, RECUR><<<grid, COH_THREADS, 0, stream>>>(a);
}

// ft: the kernel's channel capacity (1 or 8); tile: channels per
// tile; n_tiles and row_blocks: the grid (ops/coh.py:coh_geometry);
// recur: 1 when the channels are evenly spaced by ``step``. The launch
// refuses a geometry that misses or repeats a (channel, row).
extern "C" int coh_points_launch(const float* uvw3, const float* geom,
                                 const float* flux, const float* gauss,
                                 const float* freqs, float fdelta,
                                 float step, float* out, int M, int F,
                                 int B, int S, int ft, int tile,
                                 int n_tiles, int row_blocks, int recur,
                                 void* stream)
{
    if (M == 0 || F == 0 || B == 0) return 0;
    if (tile < 1 || tile > ft || (ft != 1 && ft != 8)
        || (long long)n_tiles * tile < F
        || (long long)(n_tiles - 1) * tile >= F
        || (long long)row_blocks * COH_THREADS < B
        || (long long)(row_blocks - 1) * COH_THREADS >= B
        || (recur && ft == 1))
        return (int)cudaErrorInvalidValue;
    const CohArgs a{uvw3, geom, flux, gauss, freqs, out, fdelta, step,
                    M, F, B, S, tile};
    const dim3 grid(row_blocks, n_tiles, M);
    cudaStream_t st = (cudaStream_t)stream;
    if (ft == 1) launch<1, false>(a, grid, st);
    else if (recur) launch<8, true>(a, grid, st);
    else launch<8, false>(a, grid, st);
    return (int)cudaGetLastError();
}
