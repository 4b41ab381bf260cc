// Gaussian pyramid downsample: kernel H of the port.
//
// Replaces video_stabilizer_tpu/ops/pyr_down.py:50 pyr_down (one banded
// decimation matmul and one stride-2 row pass per level, which XLA fuses;
// not a Pallas kernel), and so each level of its :80 build_pyramid. Eager
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
// 353.5 MB in and 88.4 MB out, 0.132 ms at 3.35 TB/s. One launch for the
// whole pyramid would move 353.8 MB (0.1056 ms), but on the card every way
// of handing a frame's level to the next one inside a launch cost more
// than the launch boundary it saves (PERF.md).
//
// Two engines, one for each size of level:
//   - Wide (a level of at least WIDE_OUTPUTS outputs and WIDE_COLUMNS
//     columns: the chunks' larger levels). A lane makes 8 neighbouring
//     outputs; its 16 source bytes (columns 2x .. 2x + 15) come in as one
//     aligned 16-byte load where the rows start 16 bytes apart (four word
//     loads where 4, and bytes one at a time otherwise or where the 16
//     bytes would cross the row's end), the 2 bytes to their left and the
//     1 to their right from the neighbouring lanes by shuffle (lanes 0 and
//     31 load theirs). A lane walks down its strip one output row a step,
//     the next step's 2 source rows loaded before this step's are summed,
//     keeping the first 3 source rows' share of the column sums and the
//     middle row's row sums; 64 registers, so 8 blocks an SM. Four
//     overlapping word loads a lane (the narrow engine's) need every warp
//     an SM can hold to keep device memory busy; one 16-byte load a lane
//     does not.
//   - Narrow (every other level: the small levels, one frame's, tiny
//     frames). A lane makes 4 neighbouring outputs, walking down
//     its column strip two output rows a step, the step's four new source
//     rows loaded before any is summed; the 11 source bytes of 4 outputs'
//     row come in as 4 words (columns 2x - 4 .. 2x + 11, whole words where
//     the row width is a multiple of 4), and threads whose 16 bytes would
//     cross the frame's edge gather their bytes one at a time with the
//     clamp. Its tiles are half as wide, so a small level's launch has
//     twice the blocks and each lane half the chain of work.
// In both, a 16-row strip re-reads 3 rows (9 % of the bytes, from L1 or
// L2), and levels too small to fill the card with 16-row strips take
// shorter ones: their time is the strip's chain of loads. The source bytes
// split into even and odd bytes as 16-bit lanes, two outputs a register,
// and the 5-tap sums run on both lanes at once: no lane carries into the
// other, since a row sum is at most 4,080 and the column sum at most
// 65,280. The column sum's high byte of each lane is the output (>> 8):
// byte permutes pack the outputs into one store. Frames ride gridDim.z (a
// block walks frames gridDim.z apart beyond 65,535).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;
constexpr int THREADS = 32 * WARPS;
constexpr int OX = 4;                  // outputs a lane, narrow engine
constexpr int OX8 = 8;                 // outputs a lane, wide engine
constexpr int MAX_ROWS = 16;           // output rows a warp, at most
constexpr int TILE_X = 32 * OX;        // output columns a block, narrow
constexpr int TILE_X8 = 32 * OX8;      // output columns a block, wide
constexpr int MAX_Z = 65535;
constexpr int FULL_BLOCKS = 132 * 16;  // 16 blocks on each of 132 SMs
constexpr long long WIDE_OUTPUTS = 1000000;
constexpr int WIDE_COLUMNS = 128;
constexpr uint32_t LANES = 0x00ff00ffu;
constexpr unsigned ALL = 0xffffffffu;

// -- the narrow engine ---------------------------------------------------------

// Row sums of outputs (x, x+1) in .x and (x+2, x+3) in .y, one 16-bit
// lane each, from the words of source columns 2x - 4 .. 2x + 11 (byte k of
// wd[0] is column 2x - 4 + k). With b_i = column 2x - 2 + i, E_i = b_2i
// and O_i = b_2i+1, output x + k sums E_k + 4 O_k + 6 E_k+1 + 4 O_k+1 +
// E_k+2.
__device__ __forceinline__ uint2 row_sums4(const uint32_t (&wd)[4]) {
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
__device__ __forceinline__ void emit4(uint8_t* __restrict__ o, uint2 r0,
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
__device__ __forceinline__ void strip4(const uint8_t* __restrict__ img,
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
  uint2 r0 = row_sums4(wd[0]), r1 = row_sums4(wd[1]), r2 = row_sums4(wd[2]);
  const int left = w2 - x;
  int y = y0;
  for (; y + 1 < y1; y += 2) {
#pragma unroll
    for (int i = 0; i < 4; ++i)
      load_words<FAST>(src(2 * y + 1 + i), x, w, wd[i]);
    const uint2 r3 = row_sums4(wd[0]), r4 = row_sums4(wd[1]);
    const uint2 r5 = row_sums4(wd[2]), r6 = row_sums4(wd[3]);
    emit4(dst + (long long)y * w2 + x, r0, r1, r2, r3, r4, left, word_store);
    emit4(dst + (long long)(y + 1) * w2 + x, r2, r3, r4, r5, r6, left,
         word_store);
    r0 = r4;
    r1 = r5;
    r2 = r6;
  }
  if (y < y1) {
    load_words<FAST>(src(2 * y + 1), x, w, wd[0]);
    load_words<FAST>(src(2 * y + 2), x, w, wd[1]);
    emit4(dst + (long long)y * w2 + x, r0, r1, r2, row_sums4(wd[0]),
         row_sums4(wd[1]), left, word_store);
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
      strip4<true>(img, dst, h, w, w2, x, y0, y1, word_store);
    } else {
      strip4<false>(img, dst, h, w, w2, x, y0, y1, word_store);
    }
  }
}

// -- the wide engine -----------------------------------------------------------

// How a row's 16 bytes come in: one 16-byte load, four word loads, or a
// byte at a time.
enum Vec { VEC16, VEC4, BYTES };

// The 16 source bytes of columns 2x .. 2x + 15 of one row as 4 words (byte
// k of v[q] is column 2x + 4q + k), clamped to the row where a byte lies
// outside it. `inside`: all 16 lie inside the row; `past`: the lane's
// outputs lie past the row's end, so all 16 clamp to its last byte (the
// lane on the left reads the first).
template <Vec V>
__device__ __forceinline__ void load_window(const uint8_t* __restrict__ row,
                                            int x, int w, bool inside,
                                            bool past, uint32_t (&v)[4]) {
  if (past) {
    const uint32_t last = row[w - 1] * 0x01010101u;
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = last;
    return;
  }
  if (V == VEC16 && inside) {
    const uint4 q = *reinterpret_cast<const uint4*>(row + 2 * x);
    v[0] = q.x;
    v[1] = q.y;
    v[2] = q.z;
    v[3] = q.w;
    return;
  }
  if (V == VEC4 && inside) {
    const uint32_t* p = reinterpret_cast<const uint32_t*>(row + 2 * x);
#pragma unroll
    for (int q = 0; q < 4; ++q) v[q] = p[q];
    return;
  }
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    uint32_t word = 0;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      word |= (uint32_t)row[min(2 * x + 4 * q + k, w - 1)] << (8 * k);
    v[q] = word;
  }
}

// Row sums of outputs (x + 2q, x + 2q + 1) in s[q], one 16-bit lane each,
// from the row's window v and its neighbours: bytes 2 and 3 of `left` are
// columns 2x - 2 and 2x - 1, byte 0 of `right` column 2x + 16. With b_i =
// column 2x + i, E_q = (b_4q, b_4q+2), O_q = (b_4q+1, b_4q+3), the pair q
// sums (b_4q-2, b_4q) + 4 (b_4q-1, b_4q+1) + 6 E_q + 4 O_q + (b_4q+2,
// b_4q+4).
__device__ __forceinline__ void row_sums8(const uint32_t (&v)[4],
                                         uint32_t left, uint32_t right,
                                         uint32_t (&s)[4]) {
  uint32_t e[4], o[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    e[q] = v[q] & LANES;
    o[q] = (v[q] >> 8) & LANES;
  }
  // prev[q] = (b_4q-2, b_4q), odd[q] = (b_4q-1, b_4q+1).
  uint32_t prev[5], odd[4];
  prev[0] = __byte_perm(left, e[0], 0x5452);
  odd[0] = __byte_perm(left, o[0], 0x5453);
#pragma unroll
  for (int q = 1; q < 4; ++q) {
    prev[q] = __byte_perm(e[q - 1], e[q], 0x5432);
    odd[q] = __byte_perm(o[q - 1], o[q], 0x5432);
  }
  prev[4] = __byte_perm(e[3], right, 0x3432);
#pragma unroll
  for (int q = 0; q < 4; ++q)
    s[q] = prev[q] + prev[q + 1] + 4 * (odd[q] + o[q]) + 6 * e[q];
}

// A source row's row sums from its window: the neighbours' bytes from the
// lane on each side by shuffle; lanes 0 and 31 load theirs, clamped to the
// row.
__device__ __forceinline__ void window_sums(const uint8_t* __restrict__ row,
                                            const uint32_t (&v)[4], int x,
                                            int w, int lane,
                                            uint32_t (&s)[4]) {
  uint32_t left = __shfl_up_sync(ALL, v[3], 1);
  uint32_t right = __shfl_down_sync(ALL, v[0], 1);
  if (lane == 0)
    left = (uint32_t)row[max(2 * x - 2, 0)] << 16 |
           (uint32_t)row[max(2 * x - 1, 0)] << 24;
  else if (lane == 31)
    right = row[min(2 * x + 16, w - 1)];
  row_sums8(v, left, right, s);
}

// One output row's 8 outputs: part (its first 3 source rows' share of the
// column sums) + 4 r3 + r4; `left` of them lie inside the row; `store`:
// the row's alignment (8, 4 or 1 bytes).
__device__ __forceinline__ void emit8(uint8_t* __restrict__ o,
                                     const uint32_t (&part)[4],
                                     const uint32_t (&r3)[4],
                                     const uint32_t (&r4)[4], int left,
                                     int store) {
  if (left <= 0) return;
  uint32_t a[4];
#pragma unroll
  for (int q = 0; q < 4; ++q) a[q] = part[q] + 4 * r3[q] + r4[q];
  const uint32_t lo = __byte_perm(a[0], a[1], 0x7531);  // each lane's >> 8
  const uint32_t hi = __byte_perm(a[2], a[3], 0x7531);
  if (store == 8 && left >= OX8) {
    *reinterpret_cast<uint2*>(o) = make_uint2(lo, hi);
    return;
  }
  if (store == 4 && left >= OX8) {
    reinterpret_cast<uint32_t*>(o)[0] = lo;
    reinterpret_cast<uint32_t*>(o)[1] = hi;
    return;
  }
#pragma unroll
  for (int k = 0; k < OX8; ++k)
    if (k < left) o[k] = (uint8_t)((k < 4 ? lo : hi) >> (8 * (k & 3)));
}

// Output rows y0 .. y1 - 1 of the lane's 8 columns, one a step: the next
// step's 2 source rows are loaded before this step's 2 are summed, and the
// strip carries the first 3 source rows' share of the column sums (part)
// and the middle row's row sums (mid). Every lane of the warp runs it (the
// shuffles); lanes past the row's end store nothing.
template <Vec V>
__device__ __forceinline__ void strip8(const uint8_t* __restrict__ img,
                                      uint8_t* __restrict__ dst, int h,
                                      int w, int w2, int x, int y0, int y1,
                                      int store) {
  const int lane = threadIdx.x % 32;
  const bool inside = 2 * x + 16 <= w, past = x >= w2;
  auto src = [&](int r) {  // clamped to the frame
    return img + (unsigned)(min(max(r, 0), h - 1) * w);
  };
  const int left = w2 - x;
  // part = s_(2y-2) + 4 s_(2y-1) + 6 s_(2y) before output row y; mid =
  // s_(2y): row y adds 4 s_(2y+1) + s_(2y+2).
  uint32_t part[4], mid[4], a[4], b[4], v[2][4], n[2][4];
  load_window<V>(src(2 * y0 - 2), x, w, inside, past, v[0]);
  load_window<V>(src(2 * y0 - 1), x, w, inside, past, v[1]);
  load_window<V>(src(2 * y0), x, w, inside, past, n[0]);
  window_sums(src(2 * y0 - 2), v[0], x, w, lane, a);
  window_sums(src(2 * y0 - 1), v[1], x, w, lane, b);
  window_sums(src(2 * y0), n[0], x, w, lane, mid);
#pragma unroll
  for (int q = 0; q < 4; ++q) part[q] = a[q] + 4 * b[q] + 6 * mid[q];
  load_window<V>(src(2 * y0 + 1), x, w, inside, past, v[0]);
  load_window<V>(src(2 * y0 + 2), x, w, inside, past, v[1]);
  uint8_t* out = dst + (long long)y0 * w2 + x;
  for (int y = y0; y < y1; ++y) {
    if (y + 1 < y1) {
      load_window<V>(src(2 * y + 3), x, w, inside, past, n[0]);
      load_window<V>(src(2 * y + 4), x, w, inside, past, n[1]);
    }
    window_sums(src(2 * y + 1), v[0], x, w, lane, a);
    window_sums(src(2 * y + 2), v[1], x, w, lane, b);
    emit8(out, part, a, b, left, store);
    out += w2;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      part[q] = mid[q] + 4 * a[q] + 6 * b[q];
      mid[q] = b[q];
      v[0][q] = n[0][q];
      v[1][q] = n[1][q];
    }
  }
}

// rows: output rows a warp (a block's warps stack vertically); vec: how the
// source rows come in (16-byte loads where they start 16 bytes apart, word
// loads where 4, else bytes); store: the output rows' alignment.
// 8 blocks an SM (64 registers): the engine's loads need warps in flight.
__global__ void __launch_bounds__(THREADS, 8)
    pyr_down_wide_kernel(const uint8_t* __restrict__ in,
                         uint8_t* __restrict__ out, int frames, int h, int w,
                         int h2, int w2, int rows, int vec, int store) {
  const int x = (blockIdx.x * 32 + threadIdx.x % 32) * OX8;
  const int y0 = (blockIdx.y * WARPS + threadIdx.x / 32) * rows;
  // Whole warps only: every lane takes part in the shuffles.
  if (y0 >= h2 || x - (int)(threadIdx.x % 32) * OX8 >= w2) return;
  const int y1 = min(y0 + rows, h2);
  const long long plane = (long long)h * w, plane2 = (long long)h2 * w2;
  for (int f = blockIdx.z; f < frames; f += gridDim.z) {
    const uint8_t* img = in + f * plane;
    uint8_t* dst = out + f * plane2;
    if (vec == 16)
      strip8<VEC16>(img, dst, h, w, w2, x, y0, y1, store);
    else if (vec == 4)
      strip8<VEC4>(img, dst, h, w, w2, x, y0, y1, store);
    else
      strip8<BYTES>(img, dst, h, w, w2, x, y0, y1, store);
  }
}

}  // namespace

// The longest strips (16 rows down to 2) whose blocks still fill the card.
static int strip_rows(long long columns, int h2, int z) {
  int rows = MAX_ROWS;
  while (rows > 2 &&
         columns * ((h2 + WARPS * rows - 1) / (WARPS * rows)) * z <
             FULL_BLOCKS)
    rows /= 2;
  return rows;
}

extern "C" int vs_pyr_down(const void* in, void* out, int frames, int h,
                           int w, void* stream) {
  if (frames < 1 || h < 2 || w < 2) return (int)cudaErrorInvalidValue;
  const int h2 = h / 2, w2 = w / 2;
  const int z = frames < MAX_Z ? frames : MAX_Z;
  const cudaStream_t st = (cudaStream_t)stream;
  const uint8_t* src = (const uint8_t*)in;
  uint8_t* dst = (uint8_t*)out;
  const uintptr_t in_at = (uintptr_t)in, out_at = (uintptr_t)out;
  // The wide engine's row offsets are 32-bit: frames under 2 GiB.
  if ((long long)frames * h2 * w2 >= WIDE_OUTPUTS && w2 >= WIDE_COLUMNS &&
      (long long)h * w < 0x80000000LL) {
    const long long columns = (w2 + TILE_X8 - 1) / TILE_X8;
    const int rows = strip_rows(columns, h2, z);
    const dim3 grid((unsigned)columns,
                    (h2 + WARPS * rows - 1) / (WARPS * rows), z);
    const int vec = w % 16 == 0 && in_at % 16 == 0  ? 16
                    : w % 4 == 0 && in_at % 4 == 0 ? 4
                                                   : 1;
    const int store = w2 % 8 == 0 && out_at % 8 == 0   ? 8
                      : w2 % 4 == 0 && out_at % 4 == 0 ? 4
                                                       : 1;
    pyr_down_wide_kernel<<<grid, THREADS, 0, st>>>(src, dst, frames, h, w, h2,
                                                   w2, rows, vec, store);
    return (int)cudaGetLastError();
  }
  const long long columns = (w2 + TILE_X - 1) / TILE_X;
  const int rows = strip_rows(columns, h2, z);
  const dim3 grid((unsigned)columns, (h2 + WARPS * rows - 1) / (WARPS * rows),
                  z);
  const int words = w % 4 == 0 && in_at % 4 == 0;
  const int aligned_out = w2 % 4 == 0 && out_at % 4 == 0;
  pyr_down_kernel<<<grid, THREADS, 0, st>>>(src, dst, frames, h, w, h2, w2,
                                            rows, words, aligned_out);
  return (int)cudaGetLastError();
}
