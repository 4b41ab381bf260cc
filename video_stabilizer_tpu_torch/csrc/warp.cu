// Batched output warp of the stabilizer: dst(p) = bilinear(src, W(p)) with a
// zero border, for the 4-parameter similarity W (origin based), u8 HWC in
// and out, with the stabilizer's crop fused into the output indexing.
//
// Replaces video_stabilizer_tpu/ops/pallas_warp.py::_warp_kernel (the
// similarity + bilinear form, qy_mode="taps"). It computes what that kernel
// computes, not how: each 216x512 output tile of the Pallas grid removes its
// own integer base (the warp at the tile centre, rounded half to even and
// clipped to +-192), then a separable FIR with residual bound m = 3 runs,
// y pass first. The y-pass weight is evaluated at the READ column
// x0 + u - xt, the x-pass weight at the output column. The 216x512 grid is
// part of the contract: a CUDA block here is 32x8 pixels, but every pixel
// uses the base of the 216x512 tile it lies in. The Pallas kernel's (8, 128)
// DMA rounding leaves one trace in the arithmetic: the row remainder qy,
// which shifts the argument of the y weight by an exact integer whose f32
// rounding the result depends on; it is reproduced below.
//
// Only the two taps per axis with a non-zero bilinear weight are read: every
// other tap of the Pallas FIR adds an exact 0.0, so skipping them keeps the
// f32 sums bit for bit as long as the non-zero taps keep their ascending
// order. Reads outside the image give 0, so no padded copy of the frame is
// made. Built with -fmad=false: a contracted a*b+c moves u8 rounding at .5
// boundaries.
//
// Bound on an H100: bytes. Each output pixel reads about 4 source pixels
// that neighbouring threads share through L1/L2, so the traffic the card
// must carry is one read of every frame and one write of every cropped
// output (at 1080p, 8 streams x 16 frames: 128 x (6.2 MB + 5.7 MB)). The
// design keeps to one pass with no intermediate in device memory.

#include <cuda_runtime.h>
#include <stdint.h>

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

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
  return fminf(fmaxf(v, lo), hi);
}

__global__ void warp_similarity_bilinear(const uint8_t* __restrict__ src,
                                         const float* __restrict__ ts,
                                         uint8_t* __restrict__ dst, int H,
                                         int W, int C, int crop) {
  const int Ho = H - 2 * crop;
  const int Wo = W - 2 * crop;
  const int xo = blockIdx.x * blockDim.x + threadIdx.x;
  const int yo = blockIdx.y * blockDim.y + threadIdx.y;
  const int b = blockIdx.z;
  if (xo >= Wo || yo >= Ho) return;
  const int r = yo + crop;
  const int c = xo + crop;

  const float a = ts[4 * b + 0];
  const float bb = ts[4 * b + 1];
  const float tx = ts[4 * b + 2];
  const float ty = ts[4 * b + 3];
  const float pa = 1.0f + a;

  // Integer base of the 216x512 tile holding (r, c).
  const int y0 = (r / TILE_H) * TILE_H;
  const int x0 = (c / TILE_W) * TILE_W;
  const float y0f = (float)y0;
  const float x0f = (float)x0;
  const float xc = x0f + TILE_W * 0.5f;
  const float yc = y0f + TILE_H * 0.5f;
  const float wxc = pa * xc - bb * yc + tx;
  const float wyc = bb * xc + pa * yc + ty;
  const int kx = (int)clampf(rintf(wxc - xc), -MAX_SHIFT, MAX_SHIFT);
  const int ky = (int)clampf(rintf(wyc - yc), -MAX_SHIFT, MAX_SHIFT);
  const int qy = (y0 + ky + PAD_LO - XT) & 7;  // >= 0: PAD_LO > MAX_SHIFT+XT

  const float rowf = (float)r;
  const float colf = (float)c;
  const float wx = pa * colf - bb * rowf + tx;
  const float rx = clampf((wx - colf) - (float)kx, -(float)M, (float)M);
  const int e0 = (int)floorf(rx);

  float out[MAX_C];
  for (int ch = 0; ch < MAX_C; ++ch) out[ch] = 0.0f;
  for (int k = 0; k < 2; ++k) {
    const int e = e0 + k;
    const float wgt = hat(rx - (float)e);
    if (wgt == 0.0f) continue;
    // y pass at extended column u, weight at its read column x0 + u - xt.
    const int u = (c - x0) + XT + e;
    const float colr = ((float)u - (float)XT) + x0f;
    const float wy = bb * colr + pa * rowf + ty;
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
  uint8_t* o = dst + (((size_t)b * Ho + yo) * Wo + xo) * C;
  for (int ch = 0; ch < C; ++ch)
    o[ch] = (uint8_t)clampf(rintf(out[ch]), 0.0f, 255.0f);
}

}  // namespace

extern "C" int vs_warp_frames(const void* src, const void* ts, void* dst,
                              int batch, int height, int width, int channels,
                              int crop, void* stream) {
  if (channels < 1 || channels > MAX_C || batch < 1 || batch > 65535 ||
      height - 2 * crop < 1 || width - 2 * crop < 1)
    return (int)cudaErrorInvalidValue;
  const dim3 block(32, 8);
  const dim3 grid((width - 2 * crop + block.x - 1) / block.x,
                  (height - 2 * crop + block.y - 1) / block.y, batch);
  warp_similarity_bilinear<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)src, (const float*)ts, (uint8_t*)dst, height, width,
      channels, crop);
  return (int)cudaGetLastError();
}
