// Device helpers shared by the port's kernels: the Lanczos2 polynomial, the
// bf16 rounding of the JAX package's sampling products, and the
// weight-normalized Lanczos2 sample of one keypoint from its u8 tile window
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

// Four consecutive bytes at any address, as one word (byte 0 lowest): the
// aligned words holding the first and the last byte, funnel-shifted (the
// same word twice where the address is aligned). Neither load leaves the
// aligned words that hold the four bytes.
__device__ __forceinline__ uint32_t load_bytes4(const uint8_t* p) {
  const uintptr_t a = (uintptr_t)p;
  const uint32_t lo =
      __ldg(reinterpret_cast<const uint32_t*>(a & ~(uintptr_t)3));
  const uint32_t hi =
      __ldg(reinterpret_cast<const uint32_t*>((a + 3) & ~(uintptr_t)3));
  return __funnelshift_r(lo, hi, 8u * (uint32_t)(a & 3));
}

// The weights of the 4x4 taps around a clamped window position (rx, ry):
// the first tap (ix0, iy0) and the Lanczos2 weights of the 4 columns and
// rows from there, and their normalizer (sum wy) * (sum wx).
struct TapPatch {
  int ix0, iy0;
  float wx[4], wy[4];
  float den;
};

__device__ __forceinline__ TapPatch tap_patch(float rx, float ry) {
  TapPatch t;
  t.ix0 = (int)floorf(rx) - 1;
  t.iy0 = (int)floorf(ry) - 1;
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    t.wx[k] = lanczos2((float)(t.ix0 + k) - rx);
    t.wy[k] = lanczos2((float)(t.iy0 + k) - ry);
  }
  t.den = (((t.wy[0] + t.wy[1]) + t.wy[2]) + t.wy[3]) *
          (((t.wx[0] + t.wx[1]) + t.wx[2]) + t.wx[3]);
  return t;
}

// The weight-normalized sample of a patch from its 4 rows of 4 taps (row
// ky's tap kx in byte kx of rows[ky]): products (window * wy) then (* wx),
// each rounded to bf16, summed in f32 in row-major tap order, divided by
// the normalizer.
__device__ __forceinline__ float patch_sample(const TapPatch& t,
                                              const uint32_t rows[4]) {
  float num = 0.0f;
#pragma unroll
  for (int ky = 0; ky < 4; ++ky) {
    const float wyb = bf16_round(t.wy[ky]);
#pragma unroll
    for (int kx = 0; kx < 4; ++kx) {
      const float tap = (float)((rows[ky] >> (8 * kx)) & 0xffu);
      const float p1 = bf16_round(tap * wyb);
      num += bf16_round(p1 * bf16_round(t.wx[kx]));
    }
  }
  return num / t.den;
}

// Weight-normalized Lanczos2 sample at the clamped window position (rx,
// ry) of one keypoint's P x P u8 window, P rows of P contiguous bytes
// (the port's keypoint-major (K, N, P, P) windows; `win` points at window
// n). Only the 4x4 taps that can carry weight are read (every other tap
// adds an exact 0), as 4 rows of 4 bytes: at P = 32 each row lies in one
// aligned 32-byte sector.
__device__ __forceinline__ float lanczos_window_sample(
    const uint8_t* __restrict__ win, float rx, float ry, int P) {
  const TapPatch t = tap_patch(rx, ry);
  uint32_t rows[4];
#pragma unroll
  for (int ky = 0; ky < 4; ++ky)
    rows[ky] = load_bytes4(win + (t.iy0 + ky) * P + t.ix0);
  return patch_sample(t, rows);
}
