// One pyramid level's keyframe precompute: kernel I of the port.
//
// Replaces the XLA stages video_stabilizer_tpu/models/aligner.py:163
// _compute_keyframe and video_stabilizer_tpu/models/homography_aligner.py:74
// _compute_keyframe_h, one level at a time (neither is a Pallas kernel).
// Eager PyTorch runs their plain version (ops/keyframe.py::
// keyframe_level_plain) as about 70 kernels a level: float32 gradient
// planes of every keyframe, their absolute values stacked, a row-major tile
// copy for the argmax, the Jacobian's stacks and two edge pads. Here a
// level is one launch over all K keyframes.
//
// Contract: K images of h x w bytes, contiguous; the level's tile t (ht =
// h / t, wt = w / t, N = ht * wt tiles, the bottom and right remainders
// cropped) and window margin m (P = t + 2m). With a[y][x] = the image at
// (clamp(y, 0, h-1), clamp(x, 0, w-1)):
//   gx = a[y][x+1] - a[y][x-1], gy = a[y+1][x] - a[y-1][x] (the plain
//     version's gradient is 0.5 of these, in float32: exact);
//   idx_x, idx_y (K, ht, wt) int32: within each tile the row-major index of
//     the first maximum of |gx| (|gy|): 0.5 |d| has the order and the ties
//     of the integer |d|, so the argmax runs on integers;
//   coords (K, 2 xy, 2 sets, N) f32: the argmax pixel of the X set (|gx|)
//     and of the Y set (|gy|);
//   jac: from the signed gx at the X set's argmax and gy at the Y set's,
//     similarity (K, 4, 2, N) or homography (K, 8, 2, N), each expression
//     in the plain version's order (ops/keyframe.py), every product and sum
//     rounded to float32 (round-to-nearest intrinsics, no FMA whatever the
//     flags); the scalars enter as the float32 values torch takes on the
//     card (Scalars, computed by the wrapper: the similarity's 1 / w as
//     the double rounded to float, the homography's division by w as a
//     multiply by the float32 reciprocal, as torch divides a tensor by a
//     Python float there);
//   windows (K, P, P, N) u8: window n = (i, j), pixel (r, c) = a[i t - m +
//     r][j t - m + c], clamped at the image's own edges.
// chip_smoke.py phase I holds the kernel to the plain version bit for bit.
//
// Bound on an H100: bytes. Each level read once, every output written
// once: the 1080p chunk's 64 keyframes move 176.9 MB in and 647.5 MB out
// (603.7 MB of it windows) over its 6 levels, 0.246 ms at 3.35 TB/s; the
// windows' stores set the time.
//
// The design: a block takes one tile row of one keyframe, or at wide
// levels (over 64 tiles) a span of at most 32 tiles of it, and keeps its
// shared memory under 48 KB. It loads the span's P source rows and its
// (span tiles) t + 2m columns into shared memory, edge-clamped, 16 bytes a
// lane from aligned loads (bytes at the ends), in a phase-split layout:
// column x of row y at (y t + x % t) jw + x / t. So for every window pixel
// (r, c) the span's tiles are consecutive bytes in shared memory, as they
// are along N in the output. Then
//   - the argmax: a thread takes a column of a tile and walks its t rows,
//     each pixel's (|d|, 1023 - index, sign) packed in one int, whose
//     maximum is the first maximum of |d| (the index is unique); the
//     columns' keys go to shared memory, and a thread a tile reduces them
//     and writes idx, coords and the Jacobian rows;
//   - the windows: P x P runs of (span tiles) bytes, each stored as the
//     aligned pieces it covers, 16 bytes (five shared-memory words and
//     four funnel shifts a store) where t >= 8, else 4 (two words and a
//     shift), words or bytes at the ends where a piece leaves the run.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_SPAN = 64;          // a tile row of this many is one block
constexpr int SPLIT_SPAN = 32;        // a wider one splits into spans of this
constexpr int SMEM_TARGET = 48 * 1024;
constexpr int MAX_P = 256;            // the (r, c) tables' room
constexpr int PAD = 16;               // shared bytes before the band

// Float32 scalars as torch takes them on the card (see the contract).
struct Scalars {
  float cx, cy;    // w * 0.5, h * 0.5
  float scale;     // similarity: float32(1.0 / w)
  float inv_w;     // homography: 1.0f / float32(w)
  float wf;        // homography: float32(w)
};

struct Level {
  const uint8_t* img;
  int32_t* idx_x;
  int32_t* idx_y;
  float* coords;
  float* jac;
  uint8_t* windows;
  int h, w, t, m, p, ht, wt, n;
  int span, spans;   // tiles a block, blocks a tile row
  int jw;            // shared bytes of one (row, phase) line
  int keys_at;       // shared offset of the argmax's column keys
  int piece;         // bytes a window slot stores: 16 where t >= 8, else 4
  int smax;          // slots a window run: (span + 2 piece - 2) / piece, >= 2
  uint32_t div_smax, div_p, div_t;  // __umulhi magics of smax, p and t
  int homography;
  Scalars s;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

__device__ __forceinline__ void store_jac(float* jac, int rows, long long k,
                                          int row, int set, int n, int nn,
                                          float v) {
  jac[((k * rows + row) * 2 + set) * (long long)nn + n] = v;
}

__global__ void __launch_bounds__(THREADS)
    keyframe_kernel(const Level L, long long blocks_per_key) {
  extern __shared__ uint32_t smem_words[];
  __shared__ uint8_t cmod[MAX_P], cdiv[MAX_P];
  uint8_t* const smem = reinterpret_cast<uint8_t*>(smem_words);
  uint8_t* const band = smem + PAD;   // room before it for the window reads

  const long long b = blockIdx.x;
  const long long k = b / blocks_per_key;
  const int rem = (int)(b - k * blocks_per_key);
  const int i = rem / L.spans;              // tile row
  const int j0 = (rem - i * L.spans) * L.span;
  const int nj = min(L.span, L.wt - j0);    // tiles of this block
  const int t = L.t, m = L.m, p = L.p, jw = L.jw;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;

  for (int c = tid; c < p; c += THREADS) {
    cmod[c] = (uint8_t)(c % t);
    cdiv[c] = (uint8_t)(c / t);
  }

  // The band: rows i t - m .. i t - m + P, columns j0 t - m .. (j0 + nj) t
  // + m, edge-clamped, in the phase-split layout.
  // Band columns [xa, xb) lie inside the image: their 16-byte-aligned
  // chunks come in as one load a lane; the columns before the first chunk
  // and after the last, the clamped ones included, a byte at a time.
  const uint8_t* const src = L.img + k * (long long)L.h * L.w;
  const int cols = nj * t + 2 * m;
  const int y0 = i * t - m, x0 = j0 * t - m;
  const int xa = max(0, -x0), xb = min(cols, L.w - x0);
  for (int y = warp; y < p; y += WARPS) {
    const uint8_t* row = src + (long long)clampi(y0 + y, 0, L.h - 1) * L.w;
    uint8_t* const line = band + y * t * jw;
    const int xs = xa + (int)((16 - (((uintptr_t)row + x0 + xa) & 15)) & 15);
    const int chunks = max(0, (xb - xs) >> 4);
    const int xe = xs + 16 * chunks;
    for (int c = lane; c < chunks; c += 32) {
      const int x = xs + 16 * c;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + x0 + x));
      const uint32_t word[4] = {v.x, v.y, v.z, v.w};
      int jj = (int)__umulhi((uint32_t)x, L.div_t), ph = x - jj * t;
#pragma unroll
      for (int bb = 0; bb < 16; ++bb) {
        line[ph * jw + jj] = (uint8_t)(word[bb >> 2] >> (8 * (bb & 3)));
        if (++ph == t) {
          ph = 0;
          ++jj;
        }
      }
    }
    const int rest = xs + (cols - xe);
    for (int e = lane; e < rest; e += 32) {
      const int x = e < xs ? e : xe + (e - xs);
      const int jj = (int)__umulhi((uint32_t)x, L.div_t);
      line[(x - jj * t) * jw + jj] = __ldg(row + clampi(x0 + x, 0, L.w - 1));
    }
  }
  __syncthreads();

  // The argmax, in two steps. (1) A thread takes a column of a tile (the
  // block's nj t columns, every lane busy) and walks its t rows.
  int* const keys = reinterpret_cast<int*>(smem + L.keys_at);  // [2][t][span]
  const int n0 = i * L.wt + j0;             // the block's first tile
  for (int col = tid; col < nj * t; col += THREADS) {
    const int jr = (int)__umulhi((uint32_t)col, L.div_t);
    const int tx = col - jr * t;
    const int ql = m + tx - 1, qc = m + tx, qr = m + tx + 1;
    const int ol = cmod[ql] * jw + cdiv[ql] + jr;
    const int oc = cmod[qc] * jw + cdiv[qc] + jr;
    const int orr = cmod[qr] * jw + cdiv[qr] + jr;
    const int step = t * jw;                 // one band row
    const uint8_t* line = band + m * step;
    int low = (1023 - tx) << 1;              // (1023 - index) << 1
    int above = line[oc - step], here = line[oc];
    int key_x = -1, key_y = -1;
#pragma unroll 4
    for (int ty = 0; ty < t; ++ty) {
      const int below = line[step + oc];
      const int dx = (int)line[orr] - (int)line[ol];
      const int dy = below - above;
      key_x = max(key_x, (abs(dx) << 11) | low | (int)((unsigned)dx >> 31));
      key_y = max(key_y, (abs(dy) << 11) | low | (int)((unsigned)dy >> 31));
      above = here;
      here = below;
      low -= 2 * t;
      line += step;
    }
    keys[tx * L.span + jr] = key_x;
    keys[(t + tx) * L.span + jr] = key_y;
  }
  __syncthreads();
  // (2) A thread takes a tile: the largest of its columns' keys, then idx,
  // coords and the Jacobian rows.
  for (int jr = tid; jr < nj; jr += THREADS) {
    int key_x = -1, key_y = -1;
    for (int tx = 0; tx < t; ++tx) {
      key_x = max(key_x, keys[tx * L.span + jr]);
      key_y = max(key_y, keys[(t + tx) * L.span + jr]);
    }
    {
      const int n = n0 + jr, nn = L.n;
      const int f_x = 1023 - ((key_x >> 1) & 1023);
      const int f_y = 1023 - ((key_y >> 1) & 1023);
      const int d_x = (key_x & 1) ? -(key_x >> 11) : (key_x >> 11);
      const int d_y = (key_y & 1) ? -(key_y >> 11) : (key_y >> 11);
      L.idx_x[k * nn + n] = f_x;
      L.idx_y[k * nn + n] = f_y;
      const int jt = j0 + jr;
      const float px_x = (float)(jt * t + f_x % t);
      const float py_x = (float)(i * t + f_x / t);
      const float px_y = (float)(jt * t + f_y % t);
      const float py_y = (float)(i * t + f_y / t);
      const Scalars s = L.s;
      float* const co = L.coords + k * 4 * (long long)nn + n;
      if (!L.homography) {
        // models/aligner.py's order: gx_f = 2 gval = d; (gx_f * u) * scale.
        const float gxf = (float)d_x, gyf = (float)d_y;
        const float ux = __fsub_rn(px_x, s.cx), vx = __fsub_rn(py_x, s.cy);
        const float uy = __fsub_rn(px_y, s.cx), vy = __fsub_rn(py_y, s.cy);
        store_jac(L.jac, 4, k, 0, 0, n, nn,
                  __fmul_rn(__fmul_rn(gxf, ux), s.scale));
        store_jac(L.jac, 4, k, 0, 1, n, nn,
                  __fmul_rn(__fmul_rn(gyf, vy), s.scale));
        store_jac(L.jac, 4, k, 1, 0, n, nn,
                  __fmul_rn(__fmul_rn(gxf, -vx), s.scale));
        store_jac(L.jac, 4, k, 1, 1, n, nn,
                  __fmul_rn(__fmul_rn(gyf, uy), s.scale));
        store_jac(L.jac, 4, k, 2, 0, n, nn, gxf);
        store_jac(L.jac, 4, k, 2, 1, n, nn, 0.0f);
        store_jac(L.jac, 4, k, 3, 0, n, nn, 0.0f);
        store_jac(L.jac, 4, k, 3, 1, n, nn, gyf);
        co[0] = __fadd_rn(ux, s.cx);
        co[nn] = __fadd_rn(uy, s.cx);
        co[2 * nn] = __fadd_rn(vx, s.cy);
        co[3 * nn] = __fadd_rn(vy, s.cy);
      } else {
        // homography_aligner.py's order: u = (fx - w/2) * (1/w); g = gval
        // * w; the X set's row ju(u, v) * g, the Y set's jv(u, v) * g.
        const float ux = __fmul_rn(__fsub_rn(px_x, s.cx), s.inv_w);
        const float vx = __fmul_rn(__fsub_rn(py_x, s.cy), s.inv_w);
        const float uy = __fmul_rn(__fsub_rn(px_y, s.cx), s.inv_w);
        const float vy = __fmul_rn(__fsub_rn(py_y, s.cy), s.inv_w);
        const float gx = __fmul_rn(__fmul_rn(0.5f, (float)d_x), s.wf);
        const float gy = __fmul_rn(__fmul_rn(0.5f, (float)d_y), s.wf);
        const float rx[8] = {ux, vx, 1.0f, 0.0f, 0.0f, 0.0f,
                             __fmul_rn(-ux, ux), __fmul_rn(-ux, vx)};
        const float ry[8] = {0.0f, 0.0f, 0.0f, uy, vy, 1.0f,
                             __fmul_rn(-uy, vy), __fmul_rn(-vy, vy)};
#pragma unroll
        for (int r = 0; r < 8; ++r) {
          store_jac(L.jac, 8, k, r, 0, n, nn, __fmul_rn(rx[r], gx));
          store_jac(L.jac, 8, k, r, 1, n, nn, __fmul_rn(ry[r], gy));
        }
        co[0] = px_x;
        co[nn] = px_y;
        co[2 * nn] = py_x;
        co[3 * nn] = py_y;
      }
    }
  }

  // The windows: plane q = (r, c) holds the block's nj tiles at
  // [q N + n0, q N + n0 + nj) of keyframe k, from band line (r, c % t) at
  // byte c / t on. Slot (q, s) stores the s-th aligned piece (16 or 4
  // bytes, L.piece) the run touches: one store inside the run, words or
  // bytes at its ends.
  uint8_t* const win = L.windows + k * (long long)p * p * L.n + n0;
  const int piece = L.piece, smax = L.smax;
  const int slots = p * p * smax;
  for (int e = tid; e < slots; e += THREADS) {
    const int q = (int)__umulhi((uint32_t)e, L.div_smax);
    const int sidx = e - q * smax;
    const int r = (int)__umulhi((uint32_t)q, L.div_p);
    const int c = q - r * p;
    uint8_t* const run = win + (long long)q * L.n;
    const int lo = piece * sidx - (int)((uintptr_t)run & (piece - 1));
    if (lo >= nj) continue;
    const int o = PAD + (r * t + cmod[c]) * jw + cdiv[c] + lo;
    const uint32_t* const sw = smem_words + (o >> 2);
    const int sh = 8 * (o & 3);
    uint8_t* const dst = run + lo;
    if (piece == 4) {
      const uint32_t v = __funnelshift_r(sw[0], sw[1], sh);
      if (lo >= 0 && lo + 4 <= nj) {
        *reinterpret_cast<uint32_t*>(dst) = v;
      } else {
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          if (lo + bb >= 0 && lo + bb < nj) dst[bb] = (uint8_t)(v >> (8 * bb));
        }
      }
      continue;
    }
    uint32_t v[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) v[u] = __funnelshift_r(sw[u], sw[u + 1], sh);
    if (lo >= 0 && lo + 16 <= nj) {
      *reinterpret_cast<uint4*>(dst) = make_uint4(v[0], v[1], v[2], v[3]);
      continue;
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int lw = lo + 4 * u;
      if (lw >= 0 && lw + 4 <= nj) {
        *reinterpret_cast<uint32_t*>(dst + 4 * u) = v[u];
      } else {
#pragma unroll
        for (int bb = 0; bb < 4; ++bb) {
          if (lw + bb >= 0 && lw + bb < nj)
            dst[4 * u + bb] = (uint8_t)(v[u] >> (8 * bb));
        }
      }
    }
  }
}

uint32_t umulhi_magic(int d) {
  return (uint32_t)((0x100000000ULL / (unsigned long long)d) + 1);
}

}  // namespace

// One level for K keyframes. model: 0 similarity, 1 homography. Returns a
// cudaError_t (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int vs_keyframe(const void* img, long long keys, int h, int w,
                           int t, int m, int homography, float cx, float cy,
                           float scale, float inv_w, float wf, void* idx_x,
                           void* idx_y, void* coords, void* jac,
                           void* windows, void* stream) {
  if (keys < 1 || t < 2 || t > 32 || m < 1 || h < t || w < t)
    return (int)cudaErrorInvalidValue;
  Level L;
  L.img = (const uint8_t*)img;
  L.idx_x = (int32_t*)idx_x;
  L.idx_y = (int32_t*)idx_y;
  L.coords = (float*)coords;
  L.jac = (float*)jac;
  L.windows = (uint8_t*)windows;
  L.h = h;
  L.w = w;
  L.t = t;
  L.m = m;
  L.p = t + 2 * m;
  L.ht = h / t;
  L.wt = w / t;
  L.n = L.ht * L.wt;
  if (L.p > MAX_P) return (int)cudaErrorInvalidValue;
  // The span: a tile row of up to 64 tiles, wider ones in spans of up to
  // 32 (on the card 32 beat 48 and 64 at the chunks' level 0: a span that
  // is a multiple of 16 keeps the 16-byte pieces aligned where wt and N
  // are), more where the shared band and keys would pass 48 KB.
  int smem = 0;
  for (L.spans = L.wt > MAX_SPAN ? (L.wt + SPLIT_SPAN - 1) / SPLIT_SPAN : 1;;
       ++L.spans) {
    L.span = (L.wt + L.spans - 1) / L.spans;
    L.jw = (L.span + (2 * m - 1) / t + 1 + 3) & ~3;
    if ((L.jw / 4) % 2 == 0) L.jw += 4;   // odd words: lanes spread on banks
    L.keys_at = (PAD + L.p * t * L.jw + 24 + 15) & ~15;
    smem = L.keys_at + 8 * t * L.span;
    if (smem <= SMEM_TARGET || L.span == 1) break;
  }
  L.spans = (L.wt + L.span - 1) / L.span;
  // 16-byte pieces were faster on the card at t = 10 and 20, 4-byte ones
  // at t = 2 and 4 (PERF.md).
  L.piece = t >= 8 ? 16 : 4;
  // 2 at least: the magic needs d > 1.
  L.smax = max(2, (L.span + 2 * L.piece - 2) / L.piece);
  L.div_smax = umulhi_magic(L.smax);
  L.div_p = umulhi_magic(L.p);
  L.div_t = umulhi_magic(t);
  L.homography = homography;
  L.s = Scalars{cx, cy, scale, inv_w, wf};
  const long long per_key = (long long)L.ht * L.spans;
  const long long blocks = keys * per_key;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  if (smem > SMEM_TARGET) {
    const cudaError_t err = cudaFuncSetAttribute(
        keyframe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  keyframe_kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(
      L, per_key);
  return (int)cudaGetLastError();
}
