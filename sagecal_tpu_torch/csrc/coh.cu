// Point/gaussian-source coherencies on Hopper (CUDA C++, sm_90a).
//
// Replaces the TPU kernel sagecal_tpu/ops/coh_pallas.py:_coh_kernel
// (reached through coherencies_points). For every (cluster m, channel f,
// row b) it sums over the cluster's sources s:
//   G = 2 pi (l u + m v + n w), phase = G f,
//   smear = |sin(G fdelta/2) / (G fdelta/2)| (1 at G = 0),
//   gaussian envelope pi/2 exp(-(ut^2 + vt^2)) from per-source
//   projection and shape coefficients (ut, vt linear in u, v, w, f),
// into the Stokes-weighted correlations XX, XY, YX, YY (re, im).
//
// What bounds it: arithmetic, not bytes. Each (m, f, b, s) term costs
// ~40 float32 operations (~65 for a gaussian) including one sincosf,
// one sinf, one division and, for gaussians, one expf on the SFU/libm
// path, while the bytes are O(M F B) out and O(B + M S) in. The design
// keeps every term in registers: one thread per (m, f, b) keeps its 8
// sums in registers, the block stages its cluster's 18 per-source
// floats (3 geometry, 4 Stokes weights, 11 gaussian) in shared memory
// in chunks of COH_SRC_CHUNK sources, and the output is written once,
// 32 bytes per thread, straight into the complex [M, B, F, 2, 2] layout.
// The kernel masks the ragged row tail itself (the TPU version pads B).
//
// Accuracy: the phase reaches 1e3..1e4 rad at km baselines and 150 MHz,
// so sincosf/sinf (full range reduction) are used, never the __sinf /
// __cosf intrinsics or --use_fast_math, which lose all accuracy there.

#include <cuda_runtime.h>

#define COH_THREADS 256
#define COH_SRC_CHUNK 128
#define COH_ROW 18

__global__ void __launch_bounds__(COH_THREADS)
coh_points_kernel(const float* __restrict__ uvw3,   // [3, B]
                  const float* __restrict__ geom,   // [M, 3, S]
                  const float* __restrict__ flux,   // [M, F, 4, S]
                  const float* __restrict__ gauss,  // [M, 11, S]
                  const float* __restrict__ freqs,  // [F]
                  float fdelta,
                  float* __restrict__ out,          // [M, B, F, 8]
                  int M, int F, int B, int S)
{
    __shared__ float sh[COH_ROW][COH_SRC_CHUNK];
    const float TWO_PI = 6.283185307179586f;
    const float HALF_PI = 1.5707963267948966f;
    const int m = blockIdx.z;
    const int f = blockIdx.y;
    const int b = blockIdx.x * blockDim.x + threadIdx.x;
    const bool live = b < B;
    float u = 0.f, v = 0.f, w = 0.f;
    if (live) {
        u = uvw3[b];
        v = uvw3[B + b];
        w = uvw3[2 * B + b];
    }
    const float freq = freqs[f];
    const float fd2 = fdelta * 0.5f;
    float acc[8];
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[c] = 0.f;

    for (int s0 = 0; s0 < S; s0 += COH_SRC_CHUNK) {
        const int ns = min(COH_SRC_CHUNK, S - s0);
        for (int idx = threadIdx.x; idx < COH_ROW * ns; idx += blockDim.x) {
            const int r = idx / ns;
            const int s = s0 + idx - r * ns;
            float val;
            if (r < 3)
                val = geom[((size_t)m * 3 + r) * S + s];
            else if (r < 7)
                val = flux[(((size_t)m * F + f) * 4 + (r - 3)) * S + s];
            else
                val = gauss[((size_t)m * 11 + (r - 7)) * S + s];
            sh[r][idx - r * ns] = val;
        }
        __syncthreads();
        if (live) {
            for (int s = 0; s < ns; ++s) {
                const float G = TWO_PI * (sh[0][s] * u + sh[1][s] * v
                                          + sh[2][s] * w);
                const float phase = G * freq;
                const float smfac = G * fd2;
                float smear = fabsf(smfac) > 1e-30f
                    ? fabsf(sinf(smfac) / smfac) : 1.0f;
                if (sh[17][s] > 0.f) {
                    const float up = sh[7][s] * u + sh[8][s] * v
                                     + sh[9][s] * w;
                    const float vp = sh[10][s] * u + sh[11][s] * v
                                     + sh[12][s] * w;
                    const float ut = freq * (sh[13][s] * up + sh[14][s] * vp);
                    const float vt = freq * (sh[15][s] * up + sh[16][s] * vp);
                    smear *= HALF_PI * expf(-(ut * ut + vt * vt));
                }
                float sn, cs;
                sincosf(phase, &sn, &cs);
                const float C = cs * smear;
                const float Sn = sn * smear;
                const float wIpQ = sh[3][s], wImQ = sh[4][s];
                const float wU = sh[5][s], wV = sh[6][s];
                acc[0] += wIpQ * C;
                acc[1] += wIpQ * Sn;
                acc[2] += wU * C - wV * Sn;
                acc[3] += wU * Sn + wV * C;
                acc[4] += wU * C + wV * Sn;
                acc[5] += wU * Sn - wV * C;
                acc[6] += wImQ * C;
                acc[7] += wImQ * Sn;
            }
        }
        __syncthreads();
    }
    if (live) {
        float4* o = reinterpret_cast<float4*>(
            out + (((size_t)m * B + b) * F + f) * 8);
        o[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
        o[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
    }
}

extern "C" int coh_points_launch(const float* uvw3, const float* geom,
                                 const float* flux, const float* gauss,
                                 const float* freqs, float fdelta,
                                 float* out, int M, int F, int B, int S,
                                 void* stream)
{
    if (M == 0 || F == 0 || B == 0) return 0;
    dim3 grid((B + COH_THREADS - 1) / COH_THREADS, F, M);
    coh_points_kernel<<<grid, COH_THREADS, 0, (cudaStream_t)stream>>>(
        uvw3, geom, flux, gauss, freqs, fdelta, out, M, F, B, S);
    return (int)cudaGetLastError();
}
