// Batched output warp of the stabilizer: dst(p) = interp(src, W(p)) with a
// zero border, u8 HWC in and out, with the stabilizer's crop fused into the
// output indexing. W is a 4-parameter origin-based similarity or an
// 8-parameter normalized homography; interp is bilinear or Lanczos2
// normalized by its weight sum. One template instance per (model, interp,
// channel count).
//
// The source frames are read where they lie: up to two segments of
// (stream, frame) strided frames (Segments below), so the chunked path
// warps its carried frame tail and the new chunk, and the clip path its
// strided view of the clip, without first copying them into one batch.
// The output is one contiguous batch.
//
// Replaces video_stabilizer_tpu/ops/pallas_warp.py::_warp_kernel
// (qy_mode="taps"). What it computes: each 216x512 tile of the Pallas grid,
// in source coordinates (r, c), removes its own integer base (kx, ky): the
// warp at the tile centre, rounded half to even and clipped to +-192. A
// separable FIR with residual bound m = 3 follows, y pass first. The y-pass
// value at (row r, read column u) depends on r and u alone: its weight is
// evaluated at the READ column x0 + u - xt, not at the output column that
// uses it. The x pass weighs those values at the output column. The
// Pallas kernel's (8, 128) DMA rounding leaves one trace in the arithmetic:
// the row remainder qy, an exact integer added to the y argument whose f32
// rounding the result depends on; it is reproduced below.
//
// Homography positions (pallas_warp.py:99-114): u = (x - W/2) * (1/W),
// v = (y - H/2) * (1/W), then num * (1/den) * W + W/2, in that order.
//
// Structure. A block of 128 threads covers BH x BW = 8 x 128 output pixels
// of one frame, aligned to the tile grid, so the block lies inside one tile
// (216 and 512 are multiples of 8 and 128); pixels in the crop border and
// past the frame are masked. Per block:
//   1. thread 0 computes the tile's kx, ky and qy once;
//   2. the source window the taps can reach, (BH + span - 1) rows x
//      (BW + span - 1) columns x C around (r0 + ky, c0 + kx), is staged in
//      shared memory with 16-byte loads (span = 8 bilinear, 10 Lanczos2).
//      Each shared row starts at its global row's address mod 16, so whole
//      aligned chunks copy as they are; bytes outside the frame are written
//      as 0, which is the zero border, and no padded copy of the frame is
//      made;
//   3. the y pass computes tmp[ch][row][u] (and, for Lanczos2, the y weight
//      sum den_y[row][u]) once per (row, read column) into shared memory;
//   4. the x pass, one thread per output pixel, computes the x position
//      once and sums its 2 or 4 tmp values;
//   5. the u8 results are staged in shared memory (over the window) with
//      the same mod-16 row offset, and the block's output row segments leave
//      as 16-byte stores, byte stores only at their ends.
// The channel count is a template parameter, so every per-channel array is
// in registers.
//
// The f32 order is that of the per-pixel loop (warp_kernel.py::
// warp_frames_plain): taps in ascending order, products and sums rounded
// one by one (-fmad=false), rintf, IEEE division. A tap whose weight is 0,
// or that reads outside the frame (a 0 in the window), adds an exact +-0.0,
// which leaves the sum as it was, so the result is the same whether or not
// it is skipped; a Lanczos2 tap outside the frame still adds its weight to
// den_y, as the Pallas kernel's zero-padded source does. den = sum_e wx_e *
// den_y, and the output is out / max(den, 1e-6).
//
// Bound on an H100: bytes for the bilinear forms (one read of every frame,
// one write of every cropped output), float operations for the Lanczos2
// forms (~220 per output pixel with the similarity, ~250 with the
// homography, at 3 channels: ops/warp_kernel.py::OPS_PER_PIXEL). With
// -fmad=false every product and sum is its own instruction, so an
// operation-bound form can reach at best about half the 67 TFLOP/s figure.
//
// ptxas -v (sm_90a, CUDA 12.8; chip_smoke.py phase 1 prints it and fails
// otherwise): every instance has a 0-byte stack frame and no spills.
// Registers for C = 1, 2, 3, 4 and static shared memory in bytes:
//   similarity + bilinear   39 40 40 43   6832 13072 19552 25792
//   similarity + Lanczos2   39 40 44 48  11600 18432 24992 31824
//   homography + bilinear   40 48 48 55   6832 13072 19552 25792
//   homography + Lanczos2   48 48 54 54  11600 18432 24992 31824

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
constexpr int BH = 8;                         // output rows of a block
constexpr int BW = 128;                       // output columns of a block
constexpr int THREADS = 128;
static_assert(TILE_H % BH == 0 && TILE_W % BW == 0,
              "a block must lie inside one tile");

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

// Taps of one axis: N taps from floor(residual) + FIRST. With the residual
// in [-M, M] they reach offsets [-LO, SPAN - 1 - LO] around the base.
template <int INTERP>
struct Taps {
  static constexpr int N = INTERP == BILINEAR ? 2 : 4;
  static constexpr int FIRST = INTERP == BILINEAR ? 0 : -1;
  static constexpr int LO = M - FIRST;
  static constexpr int SPAN = 2 * M + N;
  __device__ static float weight(float t) {
    return INTERP == BILINEAR ? hat(t) : lanczos2(t);
  }
};

// Shared-memory layout of one block.
template <int INTERP, int C>
struct Smem {
  static constexpr int NJ = BW + Taps<INTERP>::SPAN - 1;  // read columns
  static constexpr int WR = BH + Taps<INTERP>::SPAN - 1;  // window rows
  // A row of NJ * C bytes starting at any address mod 16 spans at most
  // (NJ * C + 30) / 16 aligned chunks.
  static constexpr int WPITCH = (NJ * C + 30) / 16 * 16;
  static constexpr int SPITCH = (BW * C + 30) / 16 * 16;
  static_assert(BH * SPITCH <= WR * WPITCH, "output stage fits the window");
  static constexpr bool DEN = INTERP == LANCZOS2;
  uint4 win[WR * WPITCH / 16];                  // window, then output stage
  float tmp[C * BH * NJ];                       // y pass, planar by channel
  float den_y[DEN ? BH * NJ : 1];               // Lanczos2 y weight sums
  int win_row[WR];                      // row start: wr * WPITCH + mod 16
  int out_shift[BH];
  int kx, ky, qy;
};

// Where the source frames lie: S streams of n_out frames each, item
// b = s * n_out + j. Frame j of stream s is frame j of segment 0 for
// j < n0, else frame j - n0 of segment 1; each segment is given by its
// base and its stream and frame strides in bytes, and a frame's rows,
// pixels and channels are contiguous. Offsets are 64-bit: 8 streams of 26
// 4K frames span 5.2 GB.
struct Segments {
  const uint8_t* base0;
  const uint8_t* base1;
  long long stream0, frame0;
  long long stream1, frame1;
  int n0, n_out;
};

template <int MODEL, int INTERP, int C>
__global__ void __launch_bounds__(THREADS)
    warp_kernel(const Segments segs, const float* __restrict__ ts,
                uint8_t* __restrict__ dst, int H, int W, int crop, int bx0,
                int by0, float inv_w) {
  using T = Taps<INTERP>;
  using S = Smem<INTERP, C>;
  constexpr int NJ = S::NJ;
  __shared__ S sm;
  uint8_t* const win = reinterpret_cast<uint8_t*>(sm.win);

  const int tid = threadIdx.x;
  const int b = blockIdx.z;
  const int r0 = (by0 + blockIdx.y) * BH;
  const int c0 = (bx0 + blockIdx.x) * BW;
  const int Ho = H - 2 * crop;
  const int Wo = W - 2 * crop;
  const long long row_bytes = (long long)W * C;
  const int s = b / segs.n_out;
  const int j = b - s * segs.n_out;
  const bool first = j < segs.n0;
  const long long src_frame =
      first ? (long long)(uintptr_t)segs.base0 + s * segs.stream0 +
                  j * segs.frame0
            : (long long)(uintptr_t)segs.base1 + s * segs.stream1 +
                  (j - segs.n0) * segs.frame1;
  const long long dst_frame = (long long)(uintptr_t)dst +
                              (long long)b * Ho * Wo * C;
  const Warp<MODEL> warp(ts + (size_t)Warp<MODEL>::NPAR * b, (float)W,
                         (float)H, inv_w);

  // 1. The integer base of the 216x512 tile holding the block.
  if (tid == 0) {
    const int y0 = (r0 / TILE_H) * TILE_H;
    const int x0 = (c0 / TILE_W) * TILE_W;
    const float xc = (float)x0 + TILE_W * 0.5f;
    const float yc = (float)y0 + TILE_H * 0.5f;
    const float wxc = warp.x(yc, xc);
    const float wyc = warp.y(yc, xc);
    const int kx = (int)clampf(rintf(wxc - xc), -MAX_SHIFT, MAX_SHIFT);
    const int ky = (int)clampf(rintf(wyc - yc), -MAX_SHIFT, MAX_SHIFT);
    sm.kx = kx;
    sm.ky = ky;
    sm.qy = (y0 + ky + PAD_LO - XT) & 7;  // >= 0: PAD_LO > MAX_SHIFT + XT
  }
  // Output row rl's byte address at column c0 (in the crop or not), mod 16.
  if (tid < BH)
    sm.out_shift[tid] = (int)((dst_frame + ((long long)(r0 + tid - crop) * Wo +
                                            (c0 - crop)) * C) & 15);
  __syncthreads();
  const int kx = sm.kx;
  const int ky = sm.ky;
  const int qy = sm.qy;

  // 2. Window row wr holds source row r0 + ky - LO + wr, columns from
  // c0 + kx - LO, starting at byte win_row[wr] of the window.
  {
    constexpr int CHUNKS = S::WPITCH / 16;
    const long long col_bytes = (long long)(c0 + kx - T::LO) * C;
    for (int k = tid; k < S::WR * CHUNKS; k += THREADS) {
      const int wr = k / CHUNKS;
      const int q = k - wr * CHUNKS;
      const int sr = r0 + ky - T::LO + wr;
      const long long row = src_frame + (long long)sr * row_bytes;
      const long long start = row + col_bytes;
      const long long a = (start & ~15LL) + 16 * q;
      const bool row_in = sr >= 0 && sr < H;
      const long long lo = row_in ? row : 0;
      const long long hi = row_in ? row + row_bytes : 0;
      uint4 v;
      if (a >= lo && a + 16 <= hi) {
        v = __ldg(reinterpret_cast<const uint4*>(a));
      } else {
        uint32_t w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
        for (int t = 0; t < 16; ++t) {
          const long long p = a + t;
          if (p >= lo && p < hi)
            w[t >> 2] |= (uint32_t)__ldg(reinterpret_cast<const uint8_t*>(p))
                         << (8 * (t & 3));
        }
        v = make_uint4(w[0], w[1], w[2], w[3]);
      }
      sm.win[wr * CHUNKS + q] = v;
      if (q == 0) sm.win_row[wr] = wr * S::WPITCH + (int)(start & 15);
    }
  }
  __syncthreads();

  // 3. y pass: tmp at (row rl, read column j) = source column
  // c0 + kx - LO + j, read column c0 - LO + j.
  const float kyf = (float)ky;
  const float qyf = (float)qy;
  for (int k = tid; k < BH * NJ; k += THREADS) {
    const int rl = k / NJ;
    const int j = k - rl * NJ;
    const float rowf = (float)(r0 + rl);
    const float colr = (float)(c0 - T::LO + j);
    const float wy = warp.y(rowf, colr);
    const float ry = clampf((wy - rowf) - kyf, -(float)M, (float)M);
    const float ry_eff = (ry + (float)XT) + qyf;
    const int d0 = (int)floorf(ry_eff) + T::FIRST;
    // Tap d reads source row r + ky - XT - qy + d: window row below.
    const int wr0 = rl + d0 - qy - XT + T::LO;
    float acc[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) acc[ch] = 0.0f;
    float den_y = 0.0f;
#pragma unroll
    for (int l = 0; l < T::N; ++l) {
      const float wyw = T::weight(ry_eff - (float)(d0 + l));
      den_y = den_y + wyw;
      const uint8_t* px = win + sm.win_row[wr0 + l] + j * C;
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        acc[ch] = acc[ch] + wyw * (float)px[ch];
    }
#pragma unroll
    for (int ch = 0; ch < C; ++ch) sm.tmp[(ch * BH + rl) * NJ + j] = acc[ch];
    if constexpr (S::DEN) sm.den_y[rl * NJ + j] = den_y;
  }
  __syncthreads();

  // 4. x pass, one thread per output pixel; results to the output stage.
  const float kxf = (float)kx;
  for (int k = tid; k < BH * BW; k += THREADS) {
    const int rl = k / BW;
    const int i = k - rl * BW;
    const int r = r0 + rl;
    const int c = c0 + i;
    if (r < crop || r >= H - crop || c < crop || c >= W - crop) continue;
    const float rowf = (float)r;
    const float colf = (float)c;
    const float wx = warp.x(rowf, colf);
    const float rx = clampf((wx - colf) - kxf, -(float)M, (float)M);
    const int e0 = (int)floorf(rx) + T::FIRST;
    float out[C];
#pragma unroll
    for (int ch = 0; ch < C; ++ch) out[ch] = 0.0f;
    float den = 0.0f;
#pragma unroll
    for (int l = 0; l < T::N; ++l) {
      const int e = e0 + l;
      const float wgt = T::weight(rx - (float)e);
      const int j = i + e + T::LO;
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        out[ch] = out[ch] + wgt * sm.tmp[(ch * BH + rl) * NJ + j];
      if constexpr (S::DEN) den = den + wgt * sm.den_y[rl * NJ + j];
    }
    uint8_t* o = win + rl * S::SPITCH + sm.out_shift[rl] + i * C;
    if constexpr (S::DEN) {
      const float dn = fmaxf(den, 1e-6f);
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        o[ch] = (uint8_t)clampf(rintf(out[ch] / dn), 0.0f, 255.0f);
    } else {
#pragma unroll
      for (int ch = 0; ch < C; ++ch)
        o[ch] = (uint8_t)clampf(rintf(out[ch]), 0.0f, 255.0f);
    }
  }
  __syncthreads();

  // 5. Stores: stage row rl byte s holds output byte (start & ~15) + s.
  {
    constexpr int CHUNKS = S::SPITCH / 16;
    const int cl = max(c0, crop);
    const int ch_end = min(c0 + BW, W - crop);
    for (int k = tid; k < BH * CHUNKS; k += THREADS) {
      const int rl = k / CHUNKS;
      const int q = k - rl * CHUNKS;
      const int r = r0 + rl;
      if (r < crop || r >= H - crop) continue;
      const long long row = dst_frame + (long long)(r - crop) * Wo * C;
      const long long start = row + (long long)(c0 - crop) * C;
      const long long a = (start & ~15LL) + 16 * q;
      const long long lo = row + (long long)(cl - crop) * C;
      const long long hi = row + (long long)(ch_end - crop) * C;
      if (a + 16 <= lo || a >= hi) continue;
      const uint4 v = sm.win[rl * (S::SPITCH / 16) + q];
      if (a >= lo && a + 16 <= hi) {
        *reinterpret_cast<uint4*>(a) = v;
      } else {
        const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int t = 0; t < 16; ++t) {
          const long long p = a + t;
          if (p >= lo && p < hi)
            *reinterpret_cast<uint8_t*>(p) =
                (uint8_t)(w[t >> 2] >> (8 * (t & 3)));
        }
      }
    }
  }
}

}  // namespace

template <int MODEL, int INTERP, int C>
void launch(dim3 grid, cudaStream_t stream, const Segments& segs,
            const void* ts, void* dst, int height, int width, int crop,
            int bx0, int by0, float inv_w) {
  warp_kernel<MODEL, INTERP, C><<<grid, THREADS, 0, stream>>>(
      segs, (const float*)ts, (uint8_t*)dst, height, width, crop, bx0, by0,
      inv_w);
}

template <int MODEL, int INTERP>
void launch_form(int channels, dim3 grid, cudaStream_t stream,
                 const Segments& segs, const void* ts, void* dst, int height,
                 int width, int crop, int bx0, int by0, float inv_w) {
  switch (channels) {
    case 1:
      launch<MODEL, INTERP, 1>(grid, stream, segs, ts, dst, height,
                               width, crop, bx0, by0, inv_w);
      break;
    case 2:
      launch<MODEL, INTERP, 2>(grid, stream, segs, ts, dst, height,
                               width, crop, bx0, by0, inv_w);
      break;
    case 3:
      launch<MODEL, INTERP, 3>(grid, stream, segs, ts, dst, height,
                               width, crop, bx0, by0, inv_w);
      break;
    default:
      launch<MODEL, INTERP, 4>(grid, stream, segs, ts, dst, height,
                               width, crop, bx0, by0, inv_w);
  }
}

// Warps S x n_out frames read from up to two segments (see Segments) into
// one contiguous (S * n_out, H - 2 crop, W - 2 crop, C) batch; ts holds
// one transform per output frame, in that order. seg1 may be null where
// n0 >= n_out. A contiguous (B, H, W, C) batch is the one-segment case:
// S = 1, n0 = n_out = B.
extern "C" int vs_warp_segments(const void* seg0, long long stream0,
                                long long frame0, int n0, const void* seg1,
                                long long stream1, long long frame1,
                                int streams, int n_out, const void* ts,
                                void* dst, int height, int width,
                                int channels, int crop, int model,
                                int interp, float inv_w, void* stream) {
  const long long batch = (long long)streams * n_out;
  if (channels < 1 || channels > MAX_C || streams < 1 || n_out < 1 ||
      batch > 65535 || n0 < 0 || (n0 > 0 && seg0 == nullptr) ||
      (n0 < n_out && seg1 == nullptr) || crop < 0 || height - 2 * crop < 1 ||
      width - 2 * crop < 1 || model < 0 || model > 1 || interp < 0 ||
      interp > 1)
    return (int)cudaErrorInvalidValue;
  const Segments segs{(const uint8_t*)seg0, (const uint8_t*)seg1, stream0,
                      frame0, stream1, frame1, n0, n_out};
  // Blocks on the BH x BW grid of source coordinates that hold output.
  const int bx0 = crop / BW;
  const int by0 = crop / BH;
  const int bx1 = (width - crop + BW - 1) / BW;
  const int by1 = (height - crop + BH - 1) / BH;
  if (by1 - by0 > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid(bx1 - bx0, by1 - by0, (unsigned)batch);
  const cudaStream_t st = (cudaStream_t)stream;
  if (model == 0 && interp == BILINEAR)
    launch_form<0, BILINEAR>(channels, grid, st, segs, ts, dst, height,
                             width, crop, bx0, by0, inv_w);
  else if (model == 0)
    launch_form<0, LANCZOS2>(channels, grid, st, segs, ts, dst, height,
                             width, crop, bx0, by0, inv_w);
  else if (interp == BILINEAR)
    launch_form<1, BILINEAR>(channels, grid, st, segs, ts, dst, height,
                             width, crop, bx0, by0, inv_w);
  else
    launch_form<1, LANCZOS2>(channels, grid, st, segs, ts, dst, height,
                             width, crop, bx0, by0, inv_w);
  return (int)cudaGetLastError();
}
