// Batched output warp of the stabilizer: dst(p) = interp(src, W(p)) with a
// zero border, u8 HWC in and out, with the stabilizer's crop fused into the
// output indexing. W is a 4-parameter origin-based similarity or an
// 8-parameter normalized homography; interp is bilinear or Lanczos2
// normalized by its weight sum. One template instance per (model, interp).
//
// Replaces video_stabilizer_tpu/ops/pallas_warp.py::_warp_kernel
// (qy_mode="taps"). It computes what that kernel computes, not how: each
// 216x512 output tile of the Pallas grid removes its own integer base (the
// warp at the tile centre, rounded half to even and clipped to +-192), then
// a separable FIR with residual bound m = 3 runs, y pass first. The y-pass
// weight is evaluated at the READ column x0 + u - xt, the x-pass weight at
// the output column. The 216x512 grid is part of the contract: a CUDA block
// here is 32x8 pixels, but every pixel uses the base of the 216x512 tile it
// lies in. The Pallas kernel's (8, 128) DMA rounding leaves one trace in the
// arithmetic: the row remainder qy, which shifts the argument of the y
// weight by an exact integer whose f32 rounding the result depends on; it
// is reproduced below.
//
// Homography positions (pallas_warp.py:99-114): u = (x - W/2) * (1/W),
// v = (y - H/2) * (1/W), then num * (1/den) * W + W/2, in that order.
//
// Only the taps with non-zero weight are read: 2 per axis for bilinear, the
// <= 4 with |argument| < 2 for Lanczos2. Every other tap of the Pallas FIR
// adds an exact 0.0, so skipping them keeps the f32 sums bit for bit as
// long as the kept taps stay in ascending order. Reads outside the image
// give 0, so no padded copy of the frame is made; a Lanczos2 tap there
// still adds its weight to the normalizer, as the zero-padded Pallas source
// does: den_y is the sum of the y weights at each read column, den =
// sum_e wx_e * den_y, and the output is out / max(den, 1e-6). Built with
// -fmad=false (a contracted a*b+c moves u8 rounding at .5 boundaries) and
// IEEE division.
//
// Bound on an H100: bytes. Each output pixel reads at most 4x4 source
// pixels that neighbouring threads share through L1/L2, so the traffic the
// card must carry is one read of every frame and one write of every cropped
// output (at 4K, 2 streams x 16 frames: 32 x (24.9 MB + 23.7 MB)). The
// design keeps to one pass with no intermediate in device memory; the
// Lanczos2 homography form also spends about 600 float operations per
// pixel (ops/warp_kernel.py::OPS_PER_PIXEL), 6x the bilinear similarity's.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lanczos_taps.cuh"

namespace {

constexpr int TILE_H = 216;
constexpr int TILE_W = 512;
constexpr int MAX_SHIFT = 192;
constexpr int M = 3;                          // residual bound after the base
constexpr int XT = M + 2;                     // tap reach per side
constexpr int PAD_LO = MAX_SHIFT + XT + 128;  // the Pallas source's low pad
constexpr int MAX_C = 4;

__device__ __forceinline__ float hat(float t) {
  return fmaxf(0.0f, 1.0f - fabsf(t));
}

// Sampling positions of the two models, in pallas_warp.py's f32 order.
template <int MODEL>
struct Warp;

template <>
struct Warp<0> {  // similarity [a, b, tx, ty], origin based
  static constexpr int NPAR = 4;
  float pa, bb, tx, ty;
  __device__ Warp(const float* t, float, float, float)
      : pa(1.0f + t[0]), bb(t[1]), tx(t[2]), ty(t[3]) {}
  __device__ float x(float row, float col) const {
    return pa * col - bb * row + tx;
  }
  __device__ float y(float row, float col) const {
    return bb * col + pa * row + ty;
  }
};

template <>
struct Warp<1> {  // normalized homography p0..p7
  static constexpr int NPAR = 8;
  float t[8];
  float img_w, cx, cy, inv_w;
  __device__ Warp(const float* tp, float w, float h, float inv_w_)
      : img_w(w), cx(w * 0.5f), cy(h * 0.5f), inv_w(inv_w_) {
    for (int k = 0; k < 8; ++k) t[k] = tp[k];
  }
  __device__ float x(float row, float col) const {
    const float u = (col - cx) * inv_w;
    const float v = (row - cy) * inv_w;
    const float num = (1.0f + t[0]) * u + t[1] * v + t[2];
    const float den = t[6] * u + t[7] * v + 1.0f;
    const float inv_den = 1.0f / den;
    return num * inv_den * img_w + cx;
  }
  __device__ float y(float row, float col) const {
    const float u = (col - cx) * inv_w;
    const float v = (row - cy) * inv_w;
    const float num = t[3] * u + (1.0f + t[4]) * v + t[5];
    const float den = t[6] * u + t[7] * v + 1.0f;
    const float inv_den = 1.0f / den;
    return num * inv_den * img_w + cy;
  }
};

constexpr int BILINEAR = 0;
constexpr int LANCZOS2 = 1;

template <int MODEL, int INTERP>
__global__ void warp_kernel(const uint8_t* __restrict__ src,
                            const float* __restrict__ ts,
                            uint8_t* __restrict__ dst, int H, int W, int C,
                            int crop, float inv_w) {
  const int Ho = H - 2 * crop;
  const int Wo = W - 2 * crop;
  const int xo = blockIdx.x * blockDim.x + threadIdx.x;
  const int yo = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (xo >= Wo || yo >= Ho) return;
  const int r = yo + crop;
  const int c = xo + crop;
  const Warp<MODEL> warp(ts + (size_t)Warp<MODEL>::NPAR * b, (float)W,
                         (float)H, inv_w);

  // Integer base of the 216x512 tile holding (r, c).
  const int y0 = (r / TILE_H) * TILE_H;
  const int x0 = (c / TILE_W) * TILE_W;
  const float y0f = (float)y0;
  const float x0f = (float)x0;
  const float xc = x0f + TILE_W * 0.5f;
  const float yc = y0f + TILE_H * 0.5f;
  const float wxc = warp.x(yc, xc);
  const float wyc = warp.y(yc, xc);
  const int kx = (int)clampf(rintf(wxc - xc), -MAX_SHIFT, MAX_SHIFT);
  const int ky = (int)clampf(rintf(wyc - yc), -MAX_SHIFT, MAX_SHIFT);
  const int qy = (y0 + ky + PAD_LO - XT) & 7;  // >= 0: PAD_LO > MAX_SHIFT+XT

  const float rowf = (float)r;
  const float colf = (float)c;
  const float wx = warp.x(rowf, colf);
  const float rx = clampf((wx - colf) - (float)kx, -(float)M, (float)M);

  float out[MAX_C];
  for (int ch = 0; ch < MAX_C; ++ch) out[ch] = 0.0f;
  uint8_t* o = dst + (((size_t)b * Ho + yo) * Wo + xo) * C;
  if (INTERP == BILINEAR) {
    const int e0 = (int)floorf(rx);
    for (int k = 0; k < 2; ++k) {
      const int e = e0 + k;
      const float wgt = hat(rx - (float)e);
      if (wgt == 0.0f) continue;
      // y pass at extended column u, weight at its read column x0 + u - xt.
      const int u = (c - x0) + XT + e;
      const float colr = ((float)u - (float)XT) + x0f;
      const float wy = warp.y(rowf, colr);
      const float ry = clampf((wy - rowf) - (float)ky, -(float)M, (float)M);
      const float ry_eff = (ry + (float)XT) + (float)qy;
      const int d0 = (int)floorf(ry_eff);
      const int sc = c + kx + e;
      float tmp[MAX_C];
      for (int ch = 0; ch < MAX_C; ++ch) tmp[ch] = 0.0f;
      for (int l = 0; l < 2; ++l) {
        const int d = d0 + l;
        const float wyw = hat(ry_eff - (float)d);
        const int sr = r + ky - XT - qy + d;
        if (wyw == 0.0f || sr < 0 || sr >= H || sc < 0 || sc >= W) continue;
        const uint8_t* px = src + (((size_t)b * H + sr) * W + sc) * C;
        for (int ch = 0; ch < C; ++ch) tmp[ch] = tmp[ch] + wyw * (float)px[ch];
      }
      for (int ch = 0; ch < C; ++ch) out[ch] = out[ch] + wgt * tmp[ch];
    }
    for (int ch = 0; ch < C; ++ch)
      o[ch] = (uint8_t)clampf(rintf(out[ch]), 0.0f, 255.0f);
    return;
  }

  // Lanczos2: the 4 taps per axis around the position; a tap outside the
  // image reads 0 but its weight counts in the normalizer.
  float den = 0.0f;
  const int e0 = (int)floorf(rx) - 1;
  for (int k = 0; k < 4; ++k) {
    const int e = e0 + k;
    const float wgt = lanczos2(rx - (float)e);
    const int u = (c - x0) + XT + e;
    const float colr = ((float)u - (float)XT) + x0f;
    const float wy = warp.y(rowf, colr);
    const float ry = clampf((wy - rowf) - (float)ky, -(float)M, (float)M);
    const float ry_eff = (ry + (float)XT) + (float)qy;
    const int d0 = (int)floorf(ry_eff) - 1;
    const int sc = c + kx + e;
    const bool col_in = sc >= 0 && sc < W;
    float tmp[MAX_C];
    for (int ch = 0; ch < MAX_C; ++ch) tmp[ch] = 0.0f;
    float den_y = 0.0f;
    for (int l = 0; l < 4; ++l) {
      const int d = d0 + l;
      const float wyw = lanczos2(ry_eff - (float)d);
      den_y = den_y + wyw;
      const int sr = r + ky - XT - qy + d;
      if (!col_in || sr < 0 || sr >= H) continue;
      const uint8_t* px = src + (((size_t)b * H + sr) * W + sc) * C;
      for (int ch = 0; ch < C; ++ch) tmp[ch] = tmp[ch] + wyw * (float)px[ch];
    }
    for (int ch = 0; ch < C; ++ch) out[ch] = out[ch] + wgt * tmp[ch];
    den = den + wgt * den_y;
  }
  const float dn = fmaxf(den, 1e-6f);
  for (int ch = 0; ch < C; ++ch)
    o[ch] = (uint8_t)clampf(rintf(out[ch] / dn), 0.0f, 255.0f);
}

}  // namespace

template <int MODEL, int INTERP>
void launch(dim3 grid, dim3 block, cudaStream_t stream, const void* src,
            const void* ts, void* dst, int height, int width, int channels,
            int crop, float inv_w) {
  warp_kernel<MODEL, INTERP><<<grid, block, 0, stream>>>(
      (const uint8_t*)src, (const float*)ts, (uint8_t*)dst, height, width,
      channels, crop, inv_w);
}

extern "C" int vs_warp_frames(const void* src, const void* ts, void* dst,
                              int batch, int height, int width, int channels,
                              int crop, int model, int interp, float inv_w,
                              void* stream) {
  if (channels < 1 || channels > MAX_C || batch < 1 || batch > 65535 ||
      height - 2 * crop < 1 || width - 2 * crop < 1 || model < 0 ||
      model > 1 || interp < 0 || interp > 1)
    return (int)cudaErrorInvalidValue;
  const dim3 block(32, 8);
  const dim3 grid((width - 2 * crop + block.x - 1) / block.x,
                  (height - 2 * crop + block.y - 1) / block.y, batch);
  const cudaStream_t st = (cudaStream_t)stream;
  if (model == 0 && interp == BILINEAR)
    launch<0, BILINEAR>(grid, block, st, src, ts, dst, height, width,
                        channels, crop, inv_w);
  else if (model == 0)
    launch<0, LANCZOS2>(grid, block, st, src, ts, dst, height, width,
                        channels, crop, inv_w);
  else if (interp == BILINEAR)
    launch<1, BILINEAR>(grid, block, st, src, ts, dst, height, width,
                        channels, crop, inv_w);
  else
    launch<1, LANCZOS2>(grid, block, st, src, ts, dst, height, width,
                        channels, crop, inv_w);
  return (int)cudaGetLastError();
}
