// Native visibility tile packer (host code; the port's copy of the JAX
// package's src/native/tile_pack.cc, unchanged below this header).
//
// The hot loop of the reference MS loader (src/MS/data.cpp:522-664
// loadData) as a standalone C++ function called through ctypes
// (sagecal_tpu_torch/io/native.py): channel averaging under the
// all-four-correlations-unflagged rule, the more-than-half-channels-good
// row rule (data.cpp:601 `nflag > Nchan/2`), the short-baseline uv taper,
// uv-cut marking (flag=2: excluded from the solve, still subtracted),
// tail padding, and the flagged-data ratio.
//
// Built with `g++ -O3 -shared -fPIC` into build/torch_kernels/ on first
// use. It is not a device kernel: the packed rows are uploaded to the
// card by the pipeline afterwards.

#include <cmath>
#include <cstdint>
#include <cstring>

extern "C" {

// vis:     [nrow, nchan, 4, 2] doubles (XX,XY,YX,YY re/im)
// cflags:  [nrow, nchan] uint8, nonzero = channel flagged
// u, v:    [nrow] doubles, METERS
// nrow:    rows actually present; nrow_total: padded tile rows
// uvmin/uvmax: uv-cut in meters (data.cpp:569-571)
// uvtaper_m: max taper baseline in meters (0 = off; data.cpp:546-550,
//            573-579: weight = min(uvd * freq0 / (taper * c), 1))
// x8:      [nrow_total, 8] out, channel-averaged reals
// rowflag: [nrow_total] out, 0 good / 1 flagged / 2 excluded-from-solve
// fratio:  out, flagged/(good+flagged) not counting flag=2 rows
void pack_tile(const double* vis, const uint8_t* cflags, const double* u,
               const double* v, int64_t nrow, int64_t nchan,
               int64_t nrow_total, double uvmin, double uvmax,
               double uvtaper_m, double freq0, double* x8,
               uint8_t* rowflag, double* fratio) {
  const double kC = 299792458.0;
  const double invtaper =
      uvtaper_m > 0.0 ? freq0 / (uvtaper_m * kC) : 0.0;
  int64_t countgood = 0, countbad = 0;
  for (int64_t r = 0; r < nrow; ++r) {
    double acc[8] = {0, 0, 0, 0, 0, 0, 0, 0};
    int64_t nflag = 0;
    const double* vr = vis + r * nchan * 8;
    const uint8_t* fr = cflags + r * nchan;
    for (int64_t k = 0; k < nchan; ++k) {
      if (!fr[k]) {
        const double* p = vr + k * 8;
        for (int c = 0; c < 8; ++c) acc[c] += p[c];
        ++nflag;
      }
    }
    const double uvd = std::sqrt(u[r] * u[r] + v[r] * v[r]);
    double taper = 1.0;
    if (invtaper > 0.0) {
      // meters -> wavelengths at freq0, capped at 1 (suppresses only the
      // baselines shorter than the taper length)
      taper = uvd * invtaper;
      if (taper > 1.0) taper = 1.0;
    }
    double* out = x8 + r * 8;
    if (2 * nflag > nchan) {
      const double s = taper / static_cast<double>(nflag);
      for (int c = 0; c < 8; ++c) out[c] = acc[c] * s;
      rowflag[r] = 0;
      ++countgood;
    } else {
      for (int c = 0; c < 8; ++c) out[c] = 0.0;
      if (nflag == 0) {
        rowflag[r] = 1;  // all channels flagged
        ++countbad;
      } else {
        rowflag[r] = 2;  // partial: subtract but exclude from solve
      }
    }
    if (uvd < uvmin || uvd > uvmax) rowflag[r] = 2;
  }
  // tail padding (data.cpp:643-657)
  for (int64_t r = nrow; r < nrow_total; ++r) {
    rowflag[r] = 1;
    std::memset(x8 + r * 8, 0, 8 * sizeof(double));
  }
  *fratio = (countgood + countbad > 0)
                ? static_cast<double>(countbad) /
                      static_cast<double>(countgood + countbad)
                : 1.0;
}

}  // extern "C"
