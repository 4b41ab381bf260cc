// Device helpers shared by the port's kernels: the Lanczos2 polynomial, the
// bf16 rounding of the JAX package's sampling products, and the
// weight-normalized Lanczos2 sample of one keypoint from u8 tile windows
// (video_stabilizer_tpu/ops/pallas_gn.py::_tap_sample,
// ops/patches.py::sample_windows_flat).
//
// Every kernel that includes this file is built with -fmad=false, so each
// product and sum below rounds where the JAX package's do.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

// Lanczos2 polynomial (generators.cpp:38-44), Horner on x^2 in the order of
// video_stabilizer_tpu/ops/lanczos.py; zero for |x| >= 2.
__device__ __forceinline__ float lanczos2(float x) {
  const float x2 = x * x;
  float v = 0.000858519f;
  v = -0.0158853f + v * x2;
  v = 0.128693f + v * x2;
  v = -0.583468f + v * x2;
  v = 1.52229f + v * x2;
  v = -2.05238f + v * x2;
  v = 0.999861f + v * x2;
  return fabsf(x) >= 2.0f ? 0.0f : v;
}

__device__ __forceinline__ float bf16_round(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

// Weight-normalized Lanczos2 sample of keypoint n at the clamped window
// position (rx, ry), from one keyframe's (P, P, N) u8 windows. Only the 4x4
// taps that can carry weight are read (every other tap adds an exact 0):
// products (window * wy) then (* wx), each rounded to bf16, summed in f32,
// divided by (sum wy) * (sum wx).
__device__ __forceinline__ float lanczos_window_sample(
    const uint8_t* __restrict__ win, float rx, float ry, int P, int N,
    int n) {
  const int ix0 = (int)floorf(rx) - 1;
  const int iy0 = (int)floorf(ry) - 1;
  float wxs[4], wys[4];
  for (int k = 0; k < 4; ++k) {
    wxs[k] = lanczos2((float)(ix0 + k) - rx);
    wys[k] = lanczos2((float)(iy0 + k) - ry);
  }
  const float den = (((wys[0] + wys[1]) + wys[2]) + wys[3]) *
                    (((wxs[0] + wxs[1]) + wxs[2]) + wxs[3]);
  float num = 0.0f;
  for (int ky = 0; ky < 4; ++ky) {
    const float wyb = bf16_round(wys[ky]);
    const uint8_t* row = win + ((size_t)(iy0 + ky) * P + ix0) * N + n;
    for (int kx = 0; kx < 4; ++kx) {
      const float p1 = bf16_round((float)row[(size_t)kx * N] * wyb);
      num += bf16_round(p1 * bf16_round(wxs[kx]));
    }
  }
  return num / den;
}
