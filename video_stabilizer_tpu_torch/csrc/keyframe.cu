// A keyframe set's precompute, every pyramid level in one launch: kernel I
// of the port.
//
// Replaces the XLA stages video_stabilizer_tpu/models/aligner.py:163
// _compute_keyframe and video_stabilizer_tpu/models/homography_aligner.py:74
// _compute_keyframe_h (neither is a Pallas kernel). Eager PyTorch runs their
// plain version (ops/keyframe.py::keyframe_level_plain) as about 70 kernels
// a level: float32 gradient planes of every keyframe, their absolute values
// stacked, a row-major tile copy for the argmax, the Jacobian's stacks and
// two edge pads. Here all levels of a set of K keyframes are one launch.
//
// Contract, for each level: K images of h x w bytes, rows contiguous, one
// keyframe kstride bytes after the last; the level's tile t (ht = h / t, wt
// = w / t, N = ht * wt tiles, the bottom and right remainders cropped) and
// window margin m (P = t + 2m). With a[y][x] = the image at (clamp(y, 0,
// h-1), clamp(x, 0, w-1)):
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
//   windows (K, N, P, P) u8, keypoint-major: window n = (i, j), P rows of P
//     contiguous bytes, pixel (r, c) = a[i t - m + r][j t - m + c], clamped
//     at the image's own edges.
// Each output is contiguous and written at its given address (the wrapper
// points it at row `offset` of the caller's set); nothing else is written.
// chip_smoke.py phase I holds the kernel to the plain version bit for bit.
//
// Bound on an H100: bytes. Each level read once, every output written
// once: the 1080p chunk's 64 keyframes move 176.9 MB in and 647.5 MB out
// (603.7 MB of it windows) over its 6 levels, 0.246 ms at 3.35 TB/s; the
// windows' stores set the time.
//
// The design. An item is a band: one tile row of one keyframe of one level,
// or at wide levels (over 64 tiles) a span of at most 32 tiles of it, fewer
// where the item's shared memory would pass SMEM_TARGET. The items of all
// levels form one list, level 0's first, and one launch runs it, a block an
// item in the list's order: the small levels fill the tail of level 0's
// waves, a level of one frame costs no launch of its own, and an item's
// windows are one contiguous run of (span tiles) P^2 bytes. A block
//   - loads its band's P source rows and (span tiles) t + 2m columns into
//     shared memory, edge-clamped (rows by choosing the source row), 16
//     bytes a lane from aligned loads (bytes at the ends), in a phase-split
//     layout: column x of row y at (y t + x % t) jw + x / t, so for every
//     window pixel (r, c) the span's tiles are consecutive bytes, as they
//     are along N in the output (where t >= 16 a 16-byte load wraps at
//     most once, so its bytes go out from two bases);
//   - runs the argmax: a thread takes one tile column of 4 neighbouring
//     tiles, one 32-bit word of each phase line, and walks its t rows in
//     4-byte SIMD: |d| by __vabsdiffu4 and, per tile, a 16-bit key (|d| << 5
//     | 31 - row) kept by __vmaxu2, whose maximum is the column's first
//     maximum; the columns' keys go to shared memory, and a thread a tile
//     takes the largest (|d|, 1023 - index), reads the sign of the winner's
//     difference from the band and writes idx, coords and the Jacobian
//     rows;
//   - stores the windows: in the phase-split layout window byte u = r P +
//     c of 4 neighbouring tiles is one 4-byte run of shared memory (line r
//     t + c % t, bytes c / t on), so a thread takes 4 tiles and one word w
//     of their windows: it reads the 4 runs of bytes u = 4w .. 4w + 3 (a
//     funnel shift of two words each), transposes the 4x4 bytes with 8
//     __byte_perm and stores one word into each tile's window; a warp's
//     lanes take consecutive words, so each store instruction writes 128
//     contiguous bytes. Where P^2 is not a multiple of 4 or the run is not
//     4-byte aligned, a byte a thread.
// Measured on the card (PERF.md): this beat persistent blocks that copied
// the next band by cp.async under the current one's stores (the copies hid
// nothing, the second buffer cost occupancy), and building the layout from
// 4-byte loads by byte permutes; a thread a tile column of 4 tiles beat one
// a column of one.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_LEVELS = 8;
constexpr int MAX_SPAN = 64;          // a tile row of this many is one item
constexpr int SPLIT_SPAN = 32;        // a wider one splits into spans of this
// 48 registers allow 5 blocks an SM, and so does this much shared memory.
constexpr int SMEM_TARGET = 44 * 1024;
constexpr int MAX_P = 256;
constexpr int PAD = 16;               // shared bytes before the band
constexpr int SLACK = 64;             // and after it (reads past a line)

// Float32 scalars as torch takes them on the card (see the contract).
struct Scalars {
  float cx, cy;    // w * 0.5, h * 0.5
  float scale;     // similarity: float32(1.0 / w)
  float inv_w;     // homography: 1.0f / float32(w)
  float wf;        // homography: float32(w)
};

struct Level {
  const uint8_t* img;
  long long kstride;  // bytes from one keyframe to the next
  int32_t* idx_x;
  int32_t* idx_y;
  float* coords;
  float* jac;
  uint8_t* windows;
  int h, w, t, m, p, ht, wt, n;
  int span, spans;   // tiles an item, items a tile row
  int jw;            // shared bytes of one (row, phase) line of the band
  int keys_at;       // shared offset of the argmax's column keys
  uint32_t div_p, div_t;  // __umulhi magics
  Scalars s;
};

struct Set {
  Level lv[MAX_LEVELS];
  int start[MAX_LEVELS + 1];  // each level's first item; then the total
  int levels;
  int homography;
};

// One item's band: keyframe k's image, its tile row and first tile, its
// tiles, and the band's first row and column and its columns.
struct Band {
  const uint8_t* src;
  int k, i, j0, nj;
  int y0, x0, cols;
};

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

// Item e of the list: its level and band.
__device__ __forceinline__ int level_of(const Set& S, int e) {
  int l = 0;
  while (l + 1 < S.levels && e >= S.start[l + 1]) ++l;
  return l;
}

__device__ __forceinline__ Band band_of(const Level& L, int r) {
  Band B;
  const int per_key = L.ht * L.spans;
  B.k = r / per_key;
  const int rem = r - B.k * per_key;
  B.i = rem / L.spans;
  B.j0 = (rem - B.i * L.spans) * L.span;
  B.nj = min(L.span, L.wt - B.j0);
  B.src = L.img + B.k * L.kstride;
  B.y0 = B.i * L.t - L.m;
  B.x0 = B.j0 * L.t - L.m;
  B.cols = B.nj * L.t + 2 * L.m;
  return B;
}

// The band: rows y0 .. y0 + P, columns x0 .. x0 + cols, edge-clamped, in
// the phase-split layout. Band columns [xa, xb) lie inside the image: their
// 16-byte-aligned chunks come in as one load a lane; the columns before
// the first chunk and after the last, the clamped ones included, a byte at
// a time.
__device__ void load_band(const Level& L, const Band& B, uint8_t* band,
                          int warp, int lane) {
  const int t = L.t, jw = L.jw;
  const int xa = max(0, -B.x0), xb = min(B.cols, L.w - B.x0);
  for (int y = warp; y < L.p; y += WARPS) {
    const uint8_t* const row =
        B.src + (long long)clampi(B.y0 + y, 0, L.h - 1) * L.w;
    uint8_t* const line = band + y * t * jw;
    const int xs =
        xa + (int)((16 - (((uintptr_t)row + B.x0 + xa) & 15)) & 15);
    const int chunks = max(0, (xb - xs) >> 4);
    const int xe = xs + 16 * chunks;
    for (int c = lane; c < chunks; c += 32) {
      const int x = xs + 16 * c;
      const uint4 v = __ldg(reinterpret_cast<const uint4*>(row + B.x0 + x));
      const uint32_t word[4] = {v.x, v.y, v.z, v.w};
      int jj = (int)__umulhi((uint32_t)x, L.div_t), ph = x - jj * t;
      if (t >= 16) {
        // At most one wrap in 16 bytes: bytes [0, lim) go to phases ph ..
        // of tile jj, the rest to phases 0 .. of tile jj + 1.
        const int lim = t - ph;
        uint8_t* const p0 = line + ph * jw + jj;
        uint8_t* const p1 = line + jj + 1 - lim * jw;
#pragma unroll
        for (int bb = 0; bb < 16; ++bb)
          (bb < lim ? p0 : p1)[bb * jw] =
              (uint8_t)(word[bb >> 2] >> (8 * (bb & 3)));
        continue;
      }
#pragma unroll
      for (int bb = 0; bb < 16; ++bb) {
        line[ph * jw + jj] = (uint8_t)(word[bb >> 2] >> (8 * (bb & 3)));
        if (++ph == t) {
          ph = 0;
          ++jj;
        }
      }
    }
    const int rest = xs + (B.cols - xe);
    for (int e = lane; e < rest; e += 32) {
      const int x = e < xs ? e : xe + (e - xs);
      const int jj = (int)__umulhi((uint32_t)x, L.div_t);
      line[(x - jj * t) * jw + jj] =
          __ldg(row + clampi(B.x0 + x, 0, L.w - 1));
    }
  }
}

// A word of shared memory at any byte offset (its shift given).
__device__ __forceinline__ uint32_t word_at(const uint32_t* sw, int wi,
                                            int sh) {
  return __funnelshift_r(sw[wi], sw[wi + 1], sh);
}

__device__ __forceinline__ void store_jac(float* jac, int rows, long long k,
                                          int row, int set, int n, int nn,
                                          float v) {
  jac[((k * rows + row) * 2 + set) * (long long)nn + n] = v;
}

// The argmax of an item, step (1): a thread a tile column of 4 tiles; the
// 16-bit column keys (|d| << 5 | 31 - row of the first maximum) to shared
// memory, keys[set][tx][tile].
__device__ void argmax_columns(const Level& L, const Band& B,
                               const uint32_t* smem_words, uint16_t* keys,
                               int tid) {
  const int t = L.t, m = L.m, jw = L.jw, span = L.span;
  const int step_w = t * jw / 4;   // one band row, in words
  const int nv = (B.nj + 3) >> 2;
  for (int e = tid; e < t * nv; e += THREADS) {
    const int v = (int)__umulhi((uint32_t)e, L.div_t);
    const int tx = e - v * t;
    // The lines of columns m + tx - 1, m + tx and m + tx + 1 of the tiles
    // 4v .. 4v + 3, at the tiles' first band row, as shared byte offsets.
    int off[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
      const int q = m + tx - 1 + a;
      const int qd = (int)__umulhi((uint32_t)q, L.div_t);
      off[a] = PAD + (m * t + q - qd * t) * jw + qd + 4 * v;
    }
    const int shl = 8 * (off[0] & 3), shc = 8 * (off[1] & 3),
              shr = 8 * (off[2] & 3);
    int wl = off[0] >> 2, wc = off[1] >> 2, wr = off[2] >> 2;
    uint32_t above = word_at(smem_words, wc - step_w, shc);
    uint32_t here = word_at(smem_words, wc, shc);
    uint32_t kx0 = 0, kx1 = 0, ky0 = 0, ky1 = 0;
    for (int ty = 0; ty < t; ++ty) {
      const uint32_t below = word_at(smem_words, wc + step_w, shc);
      const uint32_t dx = __vabsdiffu4(word_at(smem_words, wr, shr),
                                       word_at(smem_words, wl, shl));
      const uint32_t dy = __vabsdiffu4(below, above);
      // Tiles 4v, 4v + 1 in kx0's halves, 4v + 2, 4v + 3 in kx1's.
      const uint32_t rowc = (uint32_t)(31 - ty) * 0x00010001u;
      kx0 = __vmaxu2(kx0, __byte_perm(dx, 0, 0x4140) * 32u + rowc);
      kx1 = __vmaxu2(kx1, __byte_perm(dx, 0, 0x4342) * 32u + rowc);
      ky0 = __vmaxu2(ky0, __byte_perm(dy, 0, 0x4140) * 32u + rowc);
      ky1 = __vmaxu2(ky1, __byte_perm(dy, 0, 0x4342) * 32u + rowc);
      above = here;
      here = below;
      wl += step_w;
      wc += step_w;
      wr += step_w;
    }
    const uint32_t kx[2] = {kx0, kx1}, ky[2] = {ky0, ky1};
#pragma unroll
    for (int s = 0; s < 4; ++s) {
      const int jr = 4 * v + s;
      if (jr >= B.nj) break;
      keys[tx * span + jr] = (uint16_t)(kx[s >> 1] >> (16 * (s & 1)));
      keys[(t + tx) * span + jr] = (uint16_t)(ky[s >> 1] >> (16 * (s & 1)));
    }
  }
}

// Step (2)'s key (|d| << 11 | (1023 - index) << 1) of a column's 16-bit
// key: the tile's largest is its first maximum in row-major order.
__device__ __forceinline__ int tile_key(uint32_t k16, int t, int tx) {
  return (int)((k16 >> 5) << 11)
         | ((1023 - ((31 - (int)(k16 & 31)) * t + tx)) << 1);
}

// Step (2): a thread a tile: the largest of its columns' keys, the
// winner's signed differences from the band, idx, coords and the Jacobian
// rows.
__device__ void argmax_tiles(const Level& L, const Band& B,
                             const uint8_t* band, const uint16_t* keys,
                             bool homography, int tid) {
  const int t = L.t, m = L.m, jw = L.jw, nn = L.n;
  const long long k = B.k;
  const int n0 = B.i * L.wt + B.j0;
  for (int jr = tid; jr < B.nj; jr += THREADS) {
    int key_x = -1, key_y = -1;
    for (int tx = 0; tx < t; ++tx) {
      key_x = max(key_x, tile_key(keys[tx * L.span + jr], t, tx));
      key_y = max(key_y, tile_key(keys[(t + tx) * L.span + jr], t, tx));
    }
    const int f_x = 1023 - ((key_x >> 1) & 1023);
    const int f_y = 1023 - ((key_y >> 1) & 1023);
    // The band byte of (band row y, band column x).
    auto at = [&](int y, int x) -> int {
      const int xd = (int)__umulhi((uint32_t)x, L.div_t);
      return band[(y * t + x - xd * t) * jw + xd];
    };
    const int fyx = (int)__umulhi((uint32_t)f_x, L.div_t);
    const int fyy = (int)__umulhi((uint32_t)f_y, L.div_t);
    const int fxx = f_x - fyx * t, fxy = f_y - fyy * t;
    const int d_x = at(m + fyx, jr * t + m + fxx + 1)
                    - at(m + fyx, jr * t + m + fxx - 1);
    const int d_y = at(m + fyy + 1, jr * t + m + fxy)
                    - at(m + fyy - 1, jr * t + m + fxy);
    const int n = n0 + jr;
    L.idx_x[k * nn + n] = f_x;
    L.idx_y[k * nn + n] = f_y;
    const int jt = B.j0 + jr;
    const float px_x = (float)(jt * t + fxx);
    const float py_x = (float)(B.i * t + fyx);
    const float px_y = (float)(jt * t + fxy);
    const float py_y = (float)(B.i * t + fyy);
    const Scalars s = L.s;
    float* const co = L.coords + k * 4 * (long long)nn + n;
    if (!homography) {
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

// The shared byte offset of window byte u = r P + c of the item's tile 0
// (tile j's is j bytes on).
__device__ __forceinline__ int band_offset(const Level& L, int u) {
  const int r = (int)__umulhi((uint32_t)u, L.div_p);
  const int c = u - r * L.p;
  const int cd = (int)__umulhi((uint32_t)c, L.div_t);
  return PAD + (r * L.t + c - cd * L.t) * L.jw + cd;
}

// The windows of the item's nj tiles, one run of nj P^2 bytes from window
// n0 = i wt + j0 of keyframe k on. Slot (q, w): tiles 4q .. 4q + 3, word w
// of each one's window; the slots a thread takes step by THREADS, so (q,
// w) steps by (dq, dw) and w's 4 offsets change only where dw is not 0.
__device__ void store_windows(const Level& L, const Band& B,
                              const uint8_t* smem,
                              const uint32_t* smem_words, int tid) {
  const int pp = L.p * L.p, nj = B.nj;
  uint8_t* const win =
      L.windows + ((long long)B.k * L.n + B.i * L.wt + B.j0) * pp;
  if ((pp & 3) == 0 && ((uintptr_t)win & 3) == 0) {
    const int words = pp >> 2;
    const int slots = ((nj + 3) >> 2) * words;
    const int dq = THREADS / words, dw = THREADS - dq * words;
    int q = tid / words, w = tid - q * words;
    int o[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) o[b] = band_offset(L, 4 * w + b);
    for (int e = tid; e < slots; e += THREADS) {
      // v[b]'s byte d: tile 4q + d's byte 4w + b.
      uint32_t v[4];
#pragma unroll
      for (int b = 0; b < 4; ++b) {
        const int ob = o[b] + 4 * q;
        v[b] = word_at(smem_words, ob >> 2, 8 * (ob & 3));
      }
      const uint32_t lo01 = __byte_perm(v[0], v[1], 0x5140);
      const uint32_t hi01 = __byte_perm(v[0], v[1], 0x7362);
      const uint32_t lo23 = __byte_perm(v[2], v[3], 0x5140);
      const uint32_t hi23 = __byte_perm(v[2], v[3], 0x7362);
      const uint32_t out[4] = {__byte_perm(lo01, lo23, 0x5410),
                               __byte_perm(lo01, lo23, 0x7632),
                               __byte_perm(hi01, hi23, 0x5410),
                               __byte_perm(hi01, hi23, 0x7632)};
      uint32_t* const dst =
          reinterpret_cast<uint32_t*>(win + (long long)(4 * q) * pp) + w;
#pragma unroll
      for (int d = 0; d < 4; ++d) {
        if (4 * q + d < nj) dst[(long long)d * words] = out[d];
      }
      q += dq;
      if (dw != 0) {
        w += dw;
        if (w >= words) {
          w -= words;
          ++q;
        }
#pragma unroll
        for (int b = 0; b < 4; ++b) o[b] = band_offset(L, 4 * w + b);
      }
    }
    return;
  }
  const int dj = THREADS / pp, du = THREADS - dj * pp;
  int j = tid / pp, u = tid - j * pp;
  for (int e = tid; e < nj * pp; e += THREADS) {
    win[(long long)j * pp + u] = smem[band_offset(L, u) + j];
    j += dj;
    u += du;
    if (u >= pp) {
      u -= pp;
      ++j;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
    keyframe_kernel(const __grid_constant__ Set S) {
  extern __shared__ uint4 smem_vec[];
  uint8_t* const smem = reinterpret_cast<uint8_t*>(smem_vec);
  const uint32_t* const smem_words = reinterpret_cast<const uint32_t*>(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int l = level_of(S, blockIdx.x);
  const Level& L = S.lv[l];
  const Band B = band_of(L, (int)blockIdx.x - S.start[l]);
  load_band(L, B, smem + PAD, warp, lane);
  __syncthreads();
  uint16_t* const keys = reinterpret_cast<uint16_t*>(smem + L.keys_at);
  argmax_columns(L, B, smem_words, keys, tid);
  __syncthreads();
  argmax_tiles(L, B, smem + PAD, keys, S.homography != 0, tid);
  store_windows(L, B, smem, smem_words, tid);
}

uint32_t umulhi_magic(int d) {
  return (uint32_t)((0x100000000ULL / (unsigned long long)d) + 1);
}

// The plan of one level: its span, the shared layout and the magics.
// Returns an item's shared bytes.
int plan_level(Level& L) {
  const int t = L.t, m = L.m;
  int smem = 0;
  for (L.spans = L.wt > MAX_SPAN ? (L.wt + SPLIT_SPAN - 1) / SPLIT_SPAN : 1;;
       ++L.spans) {
    L.span = (L.wt + L.spans - 1) / L.spans;
    L.jw = (L.span + (2 * m - 1) / t + 1 + 3) & ~3;
    if ((L.jw / 4) % 2 == 0) L.jw += 4;   // odd words: lanes spread on banks
    L.keys_at = (PAD + L.p * t * L.jw + SLACK + 15) & ~15;
    smem = L.keys_at + 4 * t * L.span + SLACK;
    if (smem <= SMEM_TARGET || L.span == 1) break;
  }
  L.spans = (L.wt + L.span - 1) / L.span;
  L.div_p = umulhi_magic(L.p);
  L.div_t = umulhi_magic(t);
  return smem;
}

}  // namespace

// One level of a keyframe set, as the wrapper passes it (ctypes mirrors
// this layout).
struct KeyframeLevelArgs {
  const void* img;
  long long kstride;
  int h, w, t, m;
  float cx, cy, scale, inv_w, wf;
  void* idx_x;
  void* idx_y;
  void* coords;
  void* jac;
  void* windows;
};

// All levels of a set of `keys` keyframes in one launch. model: 0
// similarity, 1 homography. Returns a cudaError_t (cudaErrorInvalidValue
// for a shape the kernel does not take).
extern "C" int vs_keyframe_levels(int levels, long long keys, int homography,
                                  const KeyframeLevelArgs* args,
                                  void* stream) {
  if (levels < 1 || levels > MAX_LEVELS || keys < 1)
    return (int)cudaErrorInvalidValue;
  Set S;
  S.levels = levels;
  S.homography = homography;
  int smem = 0;
  long long total = 0;
  for (int l = 0; l < levels; ++l) {
    const KeyframeLevelArgs& a = args[l];
    Level& L = S.lv[l];
    if (a.t < 2 || a.t > 32 || a.m < 1 || a.h < a.t || a.w < a.t
        || a.t + 2 * a.m > MAX_P)
      return (int)cudaErrorInvalidValue;
    L.img = (const uint8_t*)a.img;
    L.kstride = a.kstride;
    L.idx_x = (int32_t*)a.idx_x;
    L.idx_y = (int32_t*)a.idx_y;
    L.coords = (float*)a.coords;
    L.jac = (float*)a.jac;
    L.windows = (uint8_t*)a.windows;
    L.h = a.h;
    L.w = a.w;
    L.t = a.t;
    L.m = a.m;
    L.p = a.t + 2 * a.m;
    L.ht = a.h / a.t;
    L.wt = a.w / a.t;
    L.n = L.ht * L.wt;
    L.s = Scalars{a.cx, a.cy, a.scale, a.inv_w, a.wf};
    smem = max(smem, plan_level(L));
    S.start[l] = (int)total;
    total += keys * L.ht * L.spans;
    if (total > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  }
  S.start[levels] = (int)total;
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        keyframe_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
  }
  keyframe_kernel<<<(unsigned)total, THREADS, smem, (cudaStream_t)stream>>>(
      S);
  return (int)cudaGetLastError();
}
