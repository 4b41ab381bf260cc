// Gaussian pyramid downsample: kernel H of the port.
//
// Replaces video_stabilizer_tpu/ops/pyr_down.py::pyr_down (one banded
// decimation matmul and one stride-2 row pass per level, which XLA fuses;
// not a Pallas kernel), and so each level of its build_pyramid. Eager
// PyTorch runs its plain version (ops/pyr_down.py::pyr_down_plain) as about
// 29 kernels a level: the edge pad's two gathers, an int32 cast, ten
// scalar multiplies and ten adds over int32 temporaries, the divide and the
// cast. Here a level is one launch over all N frames.
//
// Contract: N frames of H x W bytes, contiguous; N frames of (H / 2) x
// (W / 2) bytes out:
//   out[y, x] = (sum_{i,j} c_i c_j in[clamp(2y+i-2, 0, H-1),
//                                     clamp(2x+j-2, 0, W-1)]) >> 8,
// c = 1, 4, 6, 4, 1 (the [1,4,6,4,1]/16 blur with repeat-edge boundary,
// then 2x decimation and the truncating u8 cast). Integer arithmetic, so
// exact: a row sum is at most 16 x 255 = 4,080, the whole at most 65,280.
//
// Bound on an H100: bytes, 1.25 bytes a source pixel (each source byte read
// once, a quarter of a byte written); the 1080p chunk's five levels move
// 353.5 MB in and 88.4 MB out, 0.132 ms at 3.35 TB/s. What stands in the
// way is the instruction count: a byte a lane and a stencil of 25 taps is
// far more work than the bytes. The design keeps it near 16 instructions an
// output:
//   - a thread makes 4 neighbouring outputs of up to 16 rows, walking down
//     its column strip two output rows a step with the row sums it needs
//     in registers (the step's four new source rows are loaded before any
//     is summed, so that 16 loads are in flight; a 16-row strip re-reads 3
//     rows, 9 % of the bytes, from L1 or L2). Levels too small to fill the
//     card with 16-row strips take shorter ones: their time is the
//     strip's chain of loads;
//   - the 11 source bytes of 4 outputs' row come in as 4 words (columns
//     2x - 4 .. 2x + 11, whole words where the row width is a multiple of
//     4), split into even and odd bytes as 16-bit lanes, two outputs a
//     register (byte permutes and masks), and the 5-tap sums run on both
//     lanes at once: no lane carries into the other, since a row sum is
//     at most 4,080 and the column sum at most 65,280;
//   - the column sum's high byte of each lane is the output (>> 8): one
//     byte permute packs the 4 outputs into one word store.
// Threads whose 16 bytes would cross the frame's edge (and every thread
// where the row width is not a multiple of 4) gather their bytes one at a
// time with the clamp; the arithmetic is the same. Frames ride gridDim.z
// (a block walks frames gridDim.z apart beyond 65,535).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int OX = 4;                  // outputs a thread, along a row
constexpr int MAX_ROWS = 16;           // output rows a warp, at most
constexpr int TILE_X = 32 * OX;        // output columns a block
constexpr int MAX_Z = 65535;
constexpr int FULL_BLOCKS = 132 * 16;  // 16 blocks on each of 132 SMs
constexpr uint32_t LANES = 0x00ff00ffu;

// Row sums of outputs (x, x+1) in .x and (x+2, x+3) in .y, one 16-bit
// lane each, from the words of source columns 2x - 4 .. 2x + 11 (byte k of
// wd[0] is column 2x - 4 + k). With b_i = column 2x - 2 + i, E_i = b_2i
// and O_i = b_2i+1, output x + k sums E_k + 4 O_k + 6 E_k+1 + 4 O_k+1 +
// E_k+2.
__device__ __forceinline__ uint2 row_sums(const uint32_t (&wd)[4]) {
  const uint32_t w0 = wd[0], w1 = wd[1], w2 = wd[2], w3 = wd[3];
  const uint32_t e12 = w1 & LANES;                   // E1, E2
  const uint32_t o12 = (w1 >> 8) & LANES;            // O1, O2
  const uint32_t e34 = w2 & LANES;                   // E3, E4
  const uint32_t o34 = (w2 >> 8) & LANES;            // O3, O4
  const uint32_t e01 = __byte_perm(w0, e12, 0x5452);  // E0, E1
  const uint32_t o01 = __byte_perm(w0, o12, 0x5453);  // O0, O1
  const uint32_t e23 = __byte_perm(e12, e34, 0x5432);  // E2, E3
  const uint32_t o23 = __byte_perm(o12, o34, 0x5432);  // O2, O3
  const uint32_t e45 = __byte_perm(e34, w3, 0x1432);   // E4, E5
  return make_uint2(e01 + e23 + 4 * (o01 + o12) + 6 * e12,
                    e23 + e45 + 4 * (o23 + o34) + 6 * e34);
}

// The 16 bytes of source columns 2x - 4 .. 2x + 11 of one row, as words.
template <bool FAST>
__device__ __forceinline__ void load_words(const uint8_t* __restrict__ row,
                                           int x, int w, uint32_t (&wd)[4]) {
  if (FAST) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(row + 2 * x - 4);
#pragma unroll
    for (int q = 0; q < 4; ++q) wd[q] = p[q];
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int col = min(max(2 * x - 4 + 4 * q + k, 0), w - 1);
      word |= (uint32_t)row[col] << (8 * k);
    }
    wd[q] = word;
  }
}

// One output row's 4 outputs, from the row sums of its 5 source rows.
__device__ __forceinline__ void emit(uint8_t* __restrict__ o, uint2 r0,
                                     uint2 r1, uint2 r2, uint2 r3, uint2 r4,
                                     int left, bool word_store) {
  const uint32_t a = r0.x + r4.x + 4 * (r1.x + r3.x) + 6 * r2.x;
  const uint32_t b = r0.y + r4.y + 4 * (r1.y + r3.y) + 6 * r2.y;
  const uint32_t out = __byte_perm(a, b, 0x7531);  // each lane's >> 8
  if (word_store) {
    *reinterpret_cast<uint32_t*>(o) = out;
    return;
  }
#pragma unroll
  for (int k = 0; k < OX; ++k)
    if (k < left) o[k] = (uint8_t)(out >> (8 * k));
}

// Output rows y0 .. y1 - 1 of the thread's 4 columns, two rows a step: the
// step's four source rows are loaded before any is summed.
template <bool FAST>
__device__ __forceinline__ void strip(const uint8_t* __restrict__ img,
                                      uint8_t* __restrict__ dst, int h,
                                      int w, int w2, int x, int y0, int y1,
                                      bool word_store) {
  auto src = [&](int r) {
    return img + (long long)min(max(r, 0), h - 1) * w;
  };
  uint32_t wd[4][4];
#pragma unroll
  for (int i = 0; i < 3; ++i)
    load_words<FAST>(src(2 * y0 - 2 + i), x, w, wd[i]);
  uint2 r0 = row_sums(wd[0]), r1 = row_sums(wd[1]), r2 = row_sums(wd[2]);
  const int left = w2 - x;
  int y = y0;
  for (; y + 1 < y1; y += 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      load_words<FAST>(src(2 * y + 1 + i), x, w, wd[i]);
    const uint2 r3 = row_sums(wd[0]), r4 = row_sums(wd[1]);
    const uint2 r5 = row_sums(wd[2]), r6 = row_sums(wd[3]);
    emit(dst + (long long)y * w2 + x, r0, r1, r2, r3, r4, left, word_store);
    emit(dst + (long long)(y + 1) * w2 + x, r2, r3, r4, r5, r6, left,
         word_store);
    r0 = r4;
    r1 = r5;
    r2 = r6;
  }
  if (y < y1) {
    load_words<FAST>(src(2 * y + 1), x, w, wd[0]);
    load_words<FAST>(src(2 * y + 2), x, w, wd[1]);
    emit(dst + (long long)y * w2 + x, r0, r1, r2, row_sums(wd[0]),
         row_sums(wd[1]), left, word_store);
  }
}

// rows: output rows a warp (a block's warps stack vertically); words: the
// source rows can be read as whole words (W % 4 == 0, a word-aligned base).
__global__ void __launch_bounds__(THREADS)
    pyr_down_kernel(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                    int frames, int h, int w, int h2, int w2, int rows,
                    int words, int aligned_out) {
  const int x = (blockIdx.x * 32 + threadIdx.x % 32) * OX;
  const int y0 = (blockIdx.y * WARPS + threadIdx.x / 32) * rows;
  if (x >= w2 || y0 >= h2) return;
  const int y1 = min(y0 + rows, h2);
  // Whole words inside the row, and all 4 outputs inside the frame.
  const bool fast = words && x >= 2 && 2 * x + 12 <= w && x + OX <= w2;
  const bool word_store = aligned_out && x + OX <= w2;
  const long long plane = (long long)h * w, plane2 = (long long)h2 * w2;
  for (int f = blockIdx.z; f < frames; f += gridDim.z) {
    const uint8_t* img = in + f * plane;
    uint8_t* dst = out + f * plane2;
    if (fast) {
      strip<true>(img, dst, h, w, w2, x, y0, y1, word_store);
    } else {
      strip<false>(img, dst, h, w, w2, x, y0, y1, word_store);
    }
  }
}

}  // namespace

extern "C" int vs_pyr_down(const void* in, void* out, int frames, int h,
                           int w, void* stream) {
  if (frames < 1 || h < 2 || w < 2) return (int)cudaErrorInvalidValue;
  const int h2 = h / 2, w2 = w / 2;
  const int z = frames < MAX_Z ? frames : MAX_Z;
  const long long columns = (w2 + TILE_X - 1) / TILE_X;
  // The longest strips that still fill the card (small levels take
  // shorter ones: their time is the strip's chain of loads).
  int rows = MAX_ROWS;
  while (rows > 2 &&
         columns * ((h2 + WARPS * rows - 1) / (WARPS * rows)) * z <
             FULL_BLOCKS)
    rows /= 2;
  const dim3 grid((unsigned)columns, (h2 + WARPS * rows - 1) / (WARPS * rows),
                  z);
  const cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* src = (const uint8_t*)in;
  uint8_t* dst = (uint8_t*)out;
  const int words = w % 4 == 0 && (uintptr_t)in % 4 == 0;
  const int aligned_out = w2 % 4 == 0 && (uintptr_t)out % 4 == 0;
  pyr_down_kernel<<<grid, THREADS, 0, st>>>(src, dst, frames, h, w, h2, w2,
                                            rows, words, aligned_out);
  return (int)cudaGetLastError();
}
