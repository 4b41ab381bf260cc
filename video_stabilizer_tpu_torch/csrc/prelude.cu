// Select's warp-diff prelude of one pyramid level for B items: kernel J of
// the port.
//
// Replaces the XLA stages of the JAX package's level prelude,
// video_stabilizer_tpu/models/aligner.py:316-345 (inside _align_level, :293)
// and video_stabilizer_tpu/models/homography_aligner.py:130-149 (inside
// _align_level_h, :126); neither is a Pallas kernel. Eager PyTorch runs
// their plain version (ops/prelude.py::level_prelude_plain) as several dozen
// kernels a level: the template and key gathers, a (B, 2, N, 4, 4) int64
// flat index of the window taps, the Lanczos2 weights, the bf16 products,
// the histogram's scatter, cumsum and argmax, and the Hessian's broadcast
// product. Here a level is one launch.
//
// Contract, for item b of a level with N = ht * wt tiles, windows of P x P,
// key k = key_index[b] and template frame m = template_index[b]:
//   tmpl[b, s, n]: template m's byte at tile n's argmax pixel of set s
//     (idx_x for s = 0, idx_y for s = 1; row-major within the tile);
//   the warped window position of keypoint (s, n) of key k under the
//     item's incoming transform, clamped to [2, rel_hi]: the similarity's
//     centre-pivot (a, b, tx, ty) taken to the origin (W * 0.5 centre),
//     or the homography's normalized p on u = (x - w/2) * inv_w, v = (y -
//     h/2) * inv_w (torch on the card divides by a Python float as a
//     multiply by its float32 reciprocal), each expression in the plain
//     version's order;
//   wd = |sample - tmpl|, the sample the weight-normalized Lanczos2 sample
//     of the u8 windows (lanczos_taps.cuh, kernel B's sampler);
//   per (b, s) row, the histogram mode (selection="mask"): bins
//     min(floor(wd), 256); k = floor(float(N) * f) in float32 with f the
//     item's keep fraction; the threshold the first bin whose cumulative
//     count reaches k, else 257; mask = bin <= threshold (select.py:24-61
//     of the JAX package);
//   or the exact-count mode (selection="topk", select.py:64-72): mask = 1
//     on exactly k entries, the k smallest wd, equal values taken in index
//     order, lowest index first (jax.lax.top_k(-wd, k)); k (1..N) the
//     host's max(int(N * fraction), 1), capped at N, the same for every
//     item (the per-item fraction is not read);
//   jac_masked[b, r, s, n] = jac[k, r, s, n] * (mask * 0.5) (similarity:
//     the ICA X/Y-set average folded in) or * mask (homography);
//   hess[b, i, j] = sum over s, n of (jac_i * mask) * jac_j, symmetric
//     (each product rounded to float32, the sum taken in float64);
//   wd[b, s, n], where its pointer is not null (a check's debug output),
//     and in the exact-count mode mask[b, s, n] likewise.
// The keyframe's jac, coords, idx_* and windows are read through key_index
// and the template through template_index, so the plain version's
// per-item gathers and flat index never exist on the card. Every output is
// written whole. Built with -fmad=false like every kernel that samples.
//
// Bound on an H100: bytes, each input read once. Per (keyframe in use,
// set, keypoint) 8 bytes of coords, 4 R of jac and 4 of idx; per (item,
// set, keypoint) 1 template byte and the 16 window taps read, and 4 bytes
// of tmpl and 4 R of jac_masked written. Items share keyframes (a 1080p
// chunk's 128 items read 72), so this comes to about 0.05 ms a 1080p
// chunk (6 levels) or a 4K chunk (32 items, 7 levels) at 3.35 TB/s. The
// windows are keypoint-major, (K, N, P, P): a keypoint's 16 taps are 4
// rows of 4 bytes of its own window, one aligned 32-byte sector a row at P
// = 32 (levels 0 and 1), 3 or 4 sectors a patch at the coarser P, where
// the JAX package's (P, P, N) layout cost a sector a tap (about 1.6 GB at
// the 1080p chunk).
//
// The design. An item is a thread-block cluster of 1-8 CTAs (the plan's
// cluster size, ops/prelude.py::launch_plan), CTA r taking keypoints
// [r slice, (r + 1) slice) of both sets, so a level of few items still
// spreads over the card:
//   - pass 1: a lane a keypoint, a warp 32 consecutive ones, both sets
//     back to back: both sets' coords, argmax indices and template bytes
//     read first (read-only loads, __ldg, so none waits on a store), then
//     the positions, the two 4x4 patches of the keypoint's window and wd.
//     A patch is 4 rows of 4 bytes (a row from two aligned words,
//     lanczos_taps.cuh); 4 lanes read the 4 rows of one keypoint's patch,
//     so one load instruction covers 8 patches and touches 8-16 128-byte
//     lines, not 32 (the L1 serves a warp's load a line at a time), and
//     the rows go back to their lane through shared memory. tmpl (and wd)
//     go out, each entry's bin stays in dynamic shared memory as u16, and
//     an integer shared atomic adds it to its set's 257-bin histogram
//     (integer adds: the order does not matter);
//   - merge: cluster.sync; every CTA sums the cluster's histograms through
//     DSMEM in rank order, and warp s scans set s's bins (9 a lane, a
//     shuffle scan of the lane sums, a ballot for the first bin that
//     reaches k);
//   - the exact-count mode (a template parameter: the histogram mode's
//     code is the same) keeps each entry's wd bits (u32) in place of its
//     bin, and the bin t that the scan finds holds the k-th smallest wd.
//     The bits of a non-negative float sort as uint32, and bin t's entries
//     are a range of them ([bits(t), bits(t + 1)), the overflow bin from
//     bits(256) up), so a radix select refines it: rounds of 8 bits from
//     the highest byte in which the two sets' ranges differ, each a
//     histogram of the candidates' digits (integer shared atomics),
//     merged through DSMEM in rank order like the bins (two buffers by
//     round parity, the first not the bins', so one cluster.sync a round
//     keeps a CTA from overwriting what another still reads), and a scan
//     for the digit at which the count reaches the number still needed.
//     After the last round the k-th value v is known with the number of
//     entries equal to it to keep; the last round's histograms give each
//     CTA its own count of them and, summed over the lower ranks, the
//     count before its slice (a slice is contiguous, so rank order is
//     index order). The one CTA a set in which the cut falls finds its
//     local index by ballots and a prefix over its warps; pass 2 then
//     keeps bits < v, and bits == v below that index. Four bytes an entry
//     in place of two: launch_plan caps such a slice (ops/prelude.py);
//   - pass 2, in rounds of THREADS entries: a thread an entry reads its R
//     jac rows (all R loads before the first store), writes jac_masked and
//     stages the rows and the mask in shared memory; then the R (R + 1) /
//     2 distinct Hessian entries are dealt to THREADS / NH groups of NH
//     threads, thread (g, h) adding entry h's float32 product (jac_a *
//     mask) * jac_b of the staged entries g, g + THREADS / NH, ... to one
//     float64 sum. A thread holds one double, not NH: the 8x8 form kept
//     36 in registers (124 a thread, 2 CTAs an SM) in the first design;
//   - Hessian: each CTA's groups in order, the cluster's rank 0 over the
//     CTAs in rank order through DSMEM, all in float64, rounded to float32
//     once at the end; a last cluster.sync keeps every CTA's shared memory
//     alive until rank 0 has read it.
// Measured on the card (PERF.md, kernel J, the 1080p chunk's 6 levels): a
// lane a patch read 0.345 ms, 4 lanes a patch 0.316, the loads ahead of
// the stores 0.262; warp-aggregated histogram adds (__match_any_sync) and
// 6 or 8 CTAs an SM (40 or 32 registers) were slower. The exact-count mode
// read 0.314 ms there, 1.21x the histogram mode (64 registers and 4 CTAs
// an SM in both forms).
// No float atomics: a launch is deterministic, as the captured programs'
// byte-equal replays need. The float64 sums make the Hessian the float32
// rounding of the exact sum of the products (but where that lies within
// about 1e-12 of a rounding boundary), whatever the launch plan: the
// Gauss-Newton loop downstream turns a last-bit change of its Hessian into
// a different trajectory, so a kernel whose result moved with its cluster
// size would move every path's results whenever the plan is retuned.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gn_cluster.cuh"
#include "lanczos_taps.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
// Both forms hold 4 CTAs an SM (64 registers a thread at most).
constexpr int MIN_CTAS = 4;
constexpr int BINS = 257;          // 0..255 and the overflow bin 256
constexpr int BINS_PER_LANE = 9;   // 32 x 9 >= 257
constexpr int KEEP_ALL = BINS;     // the threshold when no bin reaches k
constexpr int RADIX = 256;         // the exact-count rounds' digits (8 bits)
constexpr int DIGITS_PER_LANE = RADIX / 32;

struct Level {
  const uint8_t* windows;          // (K, N, P, P)
  const float* coords;             // (K, 2 xy, 2 sets, N)
  const float* jac;                // (K, R, 2, N)
  const int32_t* idx_x;            // (K, ht, wt)
  const int32_t* idx_y;
  const int64_t* key_index;        // (B,)
  const uint8_t* templates;        // frame m at templates + m * tstride
  long long tstride;
  const int64_t* template_index;   // (B,)
  const float* transform;          // (B, 4) or (B, 8)
  const float* fraction;           // fraction[b * fstride], or null
  int fstride;
  float fvalue;                    // the keep fraction where it is null
  int k;                           // the exact-count mode's count, 1..n
  float* tmpl;                     // (B, 2, N)
  float* jac_masked;               // (B, R, 2, N)
  float* hess;                     // (B, R, R)
  float* wd;                       // (B, 2, N), or null
  float* mask;                     // (B, 2, N), or null (exact-count mode)
  int n, p, t, w, wt, margin, cluster, slice;
  float cx, cy, inv_w, wf, rel_hi;
};

// Clamped window position of a keypoint at (fx, fy) under item transform
// q: the similarity's centre-pivot (a, b, tx, ty) or the homography's p.
template <int R>
__device__ __forceinline__ void warp_position(const float* q, float fx,
                                              float fy, float ox, float oy,
                                              const Level& L, float& rx,
                                              float& ry) {
  float wx, wy;
  if constexpr (R == 4) {
    const float a = q[0], b = q[1];
    // center_to_ul (transforms.py:104), then warp_rel_positions_flat.
    const float txu = q[2] - a * L.cx + b * L.cy;
    const float tyu = q[3] - b * L.cx - a * L.cy;
    wx = (1.0f + a) * fx - b * fy + txu;
    wy = b * fx + (1.0f + a) * fy + tyu;
  } else {
    // normalized_keypoints, then warp_rel_positions_h (warp_norm).
    const float u = (fx - L.cx) * L.inv_w;
    const float v = (fy - L.cy) * L.inv_w;
    const float nx = ((1.0f + q[0]) * u + q[1] * v) + q[2];
    const float ny = (q[3] * u + (1.0f + q[4]) * v) + q[5];
    const float den = (q[6] * u + q[7] * v) + 1.0f;
    wx = nx / den * L.wf + L.cx;
    wy = ny / den * L.wf + L.cy;
  }
  rx = clampf(wx - ox, 2.0f, L.rel_hi);
  ry = clampf(wy - oy, 2.0f, L.rel_hi);
}

// The Hessian's distinct entry i (row-major over a <= b) as its (a, b).
template <int R>
__device__ __forceinline__ void hess_entry(int i, int& a, int& b) {
  a = 0;
  while (i >= R - a) {
    i -= R - a;
    ++a;
  }
  b = a + i;
}

// The local index in vals[0, cnt) just past the keep-th entry equal to v
// (0 < keep < the number of such entries), in index order: THREADS entries
// a round, a ballot a warp and a prefix over the warps. Every thread of the
// block calls it and gets the index.
__device__ __forceinline__ int tie_cut(const uint32_t* vals, int cnt,
                                        uint32_t v, int keep) {
  __shared__ int s_warp[WARPS];
  __shared__ int s_at;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // run: the equal entries of the rounds so far, the same in every thread.
  for (int base = 0, run = 0; run < keep; base += THREADS) {
    const int i = base + tid;
    const bool eq = i < cnt && vals[i] == v;
    const unsigned b = __ballot_sync(gn::FULL, eq);
    if (lane == 0) s_warp[warp] = __popc(b);
    __syncthreads();
    int before = run + __popc(b & ((1u << lane) - 1u));
    for (int w = 0; w < WARPS; ++w) {
      const int c = s_warp[w];
      if (w < warp) before += c;
      run += c;
    }
    if (eq && before == keep - 1) s_at = i + 1;
    __syncthreads();
  }
  return s_at;
}

// The exact-count mode's cut of this item's two rows, for this CTA: it
// keeps an entry of set s whose bits are below v[s], or equal to v[s] at a
// local index below cut[s]. vals: each entry's wd bits (set s at s * cnt);
// thresh, below: each set's bin holding the k-th value and the count in
// the bins under it (the merged histograms' scan). hist: this CTA's bin
// histograms, reused as a round buffer (every CTA has merged them once
// the first round's cluster.sync is passed); merged: the merged bins,
// reused for the merged digits.
__device__ __forceinline__ void exact_cut(cg::cluster_group& cluster, int cs,
                                          int rank, int k,
                                          const uint32_t* vals, int cnt,
                                          const int* thresh,
                                          const int* below, int* hist,
                                          int* merged, uint32_t* v,
                                          int* cut) {
  __shared__ int s_rad[2 * RADIX];  // the first round's buffer
  __shared__ uint32_t s_lo[2], s_hi[2];  // each set's candidate bits
  __shared__ int s_need[2], s_keep[2], s_own[2];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  if (tid < 2) {
    const int t = thresh[tid];
    s_lo[tid] = __float_as_uint((float)t);
    s_hi[tid] = t == BINS - 1 ? 0xffffffffu
                              : __float_as_uint((float)(t + 1)) - 1u;
    s_need[tid] = k - below[tid];
  }
  __syncthreads();
  // The highest byte in which either set's candidates can differ.
  const int r0 = min(__clz(s_lo[0] ^ s_hi[0]), __clz(s_lo[1] ^ s_hi[1])) >> 3;
  for (int r = r0; r < 4; ++r) {
    const int sh = 24 - 8 * r;
    int* const h = ((r - r0) & 1) ? hist : s_rad;
    for (int i = tid; i < 2 * RADIX; i += THREADS) h[i] = 0;
    __syncthreads();
    const uint32_t lo0 = s_lo[0], hi0 = s_hi[0];
    const uint32_t lo1 = s_lo[1], hi1 = s_hi[1];
    for (int e = tid; e < 2 * cnt; e += THREADS) {
      const bool s = e >= cnt;
      const uint32_t x = vals[e];
      if (x >= (s ? lo1 : lo0) && x <= (s ? hi1 : hi0))
        atomicAdd(&h[(s ? RADIX : 0) + ((x >> sh) & (RADIX - 1))], 1);
    }
    if (cs > 1) {
      cluster.sync();
    } else {
      __syncthreads();
    }
    for (int i = tid; i < 2 * RADIX; i += THREADS) {
      int c = 0;
      for (int q = 0; q < cs; ++q) {
        const int* src = cs > 1 ? cluster.map_shared_rank(h, q) : h;
        c += src[i];
      }
      merged[i] = c;
    }
    __syncthreads();
    if (warp < 2) {
      // Warp s: the first digit at which set s's candidates reach need.
      const int* cnts = merged + warp * RADIX;
      const int need = s_need[warp];
      const int d0 = lane * DIGITS_PER_LANE;
      int own[DIGITS_PER_LANE];
      int total = 0;
#pragma unroll
      for (int j = 0; j < DIGITS_PER_LANE; ++j) {
        own[j] = cnts[d0 + j];
        total += own[j];
      }
      int incl = total;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const int x = __shfl_up_sync(gn::FULL, incl, off);
        if (lane >= off) incl += x;
      }
      int run = incl - total;
      int first = -1, before = 0;
#pragma unroll
      for (int j = 0; j < DIGITS_PER_LANE; ++j) {
        if (first < 0 && run + own[j] >= need) {
          first = d0 + j;
          before = run;
        }
        run += own[j];
      }
      const int src = __ffs(__ballot_sync(gn::FULL, first >= 0)) - 1;
      const int d = __shfl_sync(gn::FULL, first, src);
      const int skipped = __shfl_sync(gn::FULL, before, src);
      if (lane == 0) {
        const uint32_t above =
            sh == 24 ? 0u : s_lo[warp] & (0xffffffffu << (sh + 8));
        const uint32_t at = above | ((uint32_t)d << sh);
        s_lo[warp] = max(s_lo[warp], at);
        s_hi[warp] = min(s_hi[warp], at | ((1u << sh) - 1u));
        s_need[warp] = need - skipped;
        if (r == 3) {
          // Equal to v: this CTA's own, and the lower ranks' before them.
          int pre = 0;
          for (int q = 0; q < rank; ++q)
            pre += cluster.map_shared_rank(h, q)[warp * RADIX + d];
          s_keep[warp] = need - skipped - pre;
          s_own[warp] = h[warp * RADIX + d];
        }
      }
    }
  }
  __syncthreads();
  for (int s = 0; s < 2; ++s) {
    const int keep = s_keep[s];
    int c = keep <= 0 ? 0 : cnt;
    if (keep > 0 && keep < s_own[s])
      c = tie_cut(vals + s * cnt, cnt, s_lo[s], keep);
    if (tid == 0) {
      v[s] = s_lo[s];
      cut[s] = c;
    }
  }
  __syncthreads();
}

template <int R, bool EXACT>
__global__ void __launch_bounds__(THREADS, MIN_CTAS)
    prelude_kernel(const Level L) {
  constexpr int NH = R * (R + 1) / 2;  // distinct Hessian entries
  constexpr int GROUPS = THREADS / NH; // threads summing one entry
  constexpr int ST = R + 1;            // a staged entry: jac rows, mask
  // (2 x slice) entries: each one's bin, or in the exact-count mode its
  // wd bits.
  extern __shared__ __align__(16) unsigned char s_dyn[];
  uint16_t* const s_bin = reinterpret_cast<uint16_t*>(s_dyn);
  uint32_t* const s_val = reinterpret_cast<uint32_t*>(s_dyn);
  __shared__ int s_hist[2 * BINS];     // this CTA's histograms
  __shared__ int s_count[2 * BINS];    // the cluster's
  __shared__ int s_thresh[2];
  __shared__ int s_below[2];           // exact: the count under s_thresh
  __shared__ uint32_t s_v[2];          // exact: the k-th value's bits
  __shared__ int s_cut[2];             // exact: this CTA's tie cut
  __shared__ float s_stage[THREADS * ST];
  __shared__ double s_part[GROUPS * NH];
  __shared__ double s_cta[NH];
  __shared__ __align__(16) uint32_t s_rows[WARPS][32][4];

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = L.cluster;
  const int rank = (int)cluster.block_rank();
  const int item = blockIdx.x / cs;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int N = L.n;
  const int lo = min(rank * L.slice, N);
  const int cnt = min(N, lo + L.slice) - lo;

  for (int i = tid; i < 2 * BINS; i += THREADS) s_hist[i] = 0;
  __syncthreads();

  const size_t key = (size_t)L.key_index[item];
  const size_t pp = (size_t)L.p * L.p;
  const uint8_t* win = L.windows + key * N * pp;
  const float* fxk = L.coords + key * 4 * N;  // [xy][set][n]
  const int32_t* idx_x = L.idx_x + key * N;
  const int32_t* idx_y = L.idx_y + key * N;
  const uint8_t* frame =
      L.templates + (long long)L.template_index[item] * L.tstride;
  float q[R];
#pragma unroll
  for (int k = 0; k < R; ++k) q[k] = L.transform[(size_t)item * R + k];

  // Pass 1: a lane a keypoint, a warp 32 consecutive ones, both sets:
  // position, the 4 rows of the keypoint's patch (read by 4 lanes, one row
  // each, so a load instruction covers 8 patches; passed back through
  // s_rows), the sample, template byte, wd and its bin. A lane past the
  // slice shadows its warp's first keypoint and stores nothing.
  uint32_t (*const rows_of)[4] = s_rows[warp];
  for (int i0 = warp * 32; i0 < cnt; i0 += THREADS) {
    const int i = i0 + lane;
    const bool live = i < cnt;
    const int n = lo + (live ? i : i0);
    const int ty = n / L.wt;
    const int tx = n - ty * L.wt;
    const float ox = (float)(tx * L.t - L.margin);
    const float oy = (float)(ty * L.t - L.margin);
    // Both sets' inputs up front (read-only loads, so none waits on the
    // other set's stores): coords, argmax indices, template bytes.
    float fx[2], fy[2], tvs[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      fx[s] = __ldg(fxk + s * N + n);
      fy[s] = __ldg(fxk + 2 * N + s * N + n);
      const int idx = __ldg((s ? idx_y : idx_x) + n);
      const int py = ty * L.t + idx / L.t;
      const int px = tx * L.t + idx % L.t;
      tvs[s] = (float)__ldg(frame + (size_t)py * L.w + px);
    }
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      float rx, ry;
      warp_position<R>(q, fx[s], fy[s], ox, oy, L, rx, ry);
      const float tv = tvs[s];
      const TapPatch tp = tap_patch(rx, ry);
      const int first = n * L.p * L.p + tp.iy0 * L.p + tp.ix0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int src = 8 * k + (lane >> 2);
        const int at = __shfl_sync(gn::FULL, first, src);
        rows_of[src][lane & 3] = load_bytes4(win + at + (lane & 3) * L.p);
      }
      __syncwarp();
      const uint4 r4 = *reinterpret_cast<const uint4*>(rows_of[lane]);
      __syncwarp();
      const uint32_t rows[4] = {r4.x, r4.y, r4.z, r4.w};
      const float sample = patch_sample(tp, rows);
      if (!live) continue;
      const float d = fabsf(sample - tv);
      const size_t out = ((size_t)item * 2 + s) * N + n;
      L.tmpl[out] = tv;
      if (L.wd != nullptr) L.wd[out] = d;
      const int bin = (int)fminf(floorf(d), (float)(BINS - 1));
      if constexpr (EXACT) {
        s_val[s * cnt + i] = __float_as_uint(d);
      } else {
        s_bin[s * cnt + i] = (uint16_t)bin;
      }
      atomicAdd(&s_hist[s * BINS + bin], 1);
    }
  }

  // Merge: the cluster's counts, in rank order, then one scan a set.
  if (cs > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
  for (int i = tid; i < 2 * BINS; i += THREADS) {
    int c = 0;
    for (int r = 0; r < cs; ++r) {
      const int* src = cs > 1 ? cluster.map_shared_rank(s_hist, r) : s_hist;
      c += src[i];
    }
    s_count[i] = c;
  }
  __syncthreads();
  if (warp < 2) {
    float k = 0.0f;
    if constexpr (!EXACT) {
      const float f =
          L.fraction != nullptr ? L.fraction[(size_t)item * L.fstride]
                                : L.fvalue;
      k = floorf((float)N * f);
    }
    const int* cnts = s_count + warp * BINS;
    const int b0 = lane * BINS_PER_LANE;
    int own[BINS_PER_LANE];
    int total = 0;
#pragma unroll
    for (int j = 0; j < BINS_PER_LANE; ++j) {
      own[j] = b0 + j < BINS ? cnts[b0 + j] : 0;
      total += own[j];
    }
    int incl = total;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int v = __shfl_up_sync(gn::FULL, incl, off);
      if (lane >= off) incl += v;
    }
    int run = incl - total;
    int first = KEEP_ALL, below = 0;
#pragma unroll
    for (int j = 0; j < BINS_PER_LANE; ++j) {
      run += own[j];
      if (first == KEEP_ALL && b0 + j < BINS &&
          (EXACT ? run >= L.k : (float)run >= k)) {
        first = b0 + j;
        below = run - own[j];
      }
    }
    const unsigned hit = __ballot_sync(gn::FULL, first != KEEP_ALL);
    const int thresh =
        hit ? __shfl_sync(gn::FULL, first, __ffs(hit) - 1) : KEEP_ALL;
    if (lane == 0) s_thresh[warp] = thresh;
    if constexpr (EXACT) {
      // k <= N: a bin always reaches it.
      below = __shfl_sync(gn::FULL, below, __ffs(hit) - 1);
      if (lane == 0) s_below[warp] = below;
    }
  }
  __syncthreads();
  if constexpr (EXACT)
    exact_cut(cluster, cs, rank, L.k, s_val, cnt, s_thresh, s_below, s_hist,
              s_count, s_v, s_cut);

  // Pass 2: a thread an entry stages its jac rows and mask and writes
  // jac_masked; then thread (group g, entry h) adds the products of entry
  // h of the staged entries g, g + GROUPS, ... in float64.
  const int th0 = s_thresh[0];
  const int th1 = s_thresh[1];
  const float* jk = L.jac + key * R * 2 * N;
  float* jm_out = L.jac_masked + (size_t)item * R * 2 * N;
  const int grp = tid / NH;
  int ha, hb;
  hess_entry<R>(tid - grp * NH, ha, hb);
  double acc = 0.0;
  for (int base = 0; base < 2 * cnt; base += THREADS) {
    const int e = base + tid;
    if (e < 2 * cnt) {
      const int s = e >= cnt;
      const int n = lo + (s ? e - cnt : e);
      float m;
      if constexpr (EXACT) {
        const uint32_t x = s_val[e];
        const uint32_t v = s_v[s];
        m = x < v || (x == v && (s ? e - cnt : e) < s_cut[s]) ? 1.0f : 0.0f;
        if (L.mask != nullptr) L.mask[((size_t)item * 2 + s) * N + n] = m;
      } else {
        m = (int)s_bin[e] <= (s ? th1 : th0) ? 1.0f : 0.0f;
      }
      const float mj = R == 4 ? m * 0.5f : m;
      float* st = s_stage + tid * ST;
      // Every row's load issued before the first store.
      float j[R];
#pragma unroll
      for (int r = 0; r < R; ++r)
        j[r] = __ldg(jk + (size_t)(r * 2 + s) * N + n);
#pragma unroll
      for (int r = 0; r < R; ++r) {
        jm_out[(size_t)(r * 2 + s) * N + n] = j[r] * mj;
        st[r] = j[r];
      }
      st[R] = m;
    }
    __syncthreads();
    const int staged = min(THREADS, 2 * cnt - base);
    if (grp < GROUPS) {
      for (int i = grp; i < staged; i += GROUPS) {
        const float* st = s_stage + i * ST;
        const float ja = st[ha] * st[R];
        acc += (double)(ja * st[hb]);
      }
    }
    __syncthreads();
  }

  // Hessian: the groups of the CTA in order, then the cluster's CTAs in
  // rank order.
  if (grp < GROUPS) s_part[grp * NH + (tid - grp * NH)] = acc;
  __syncthreads();
  if (tid < NH) {
    double v = 0.0;
    for (int g = 0; g < GROUPS; ++g) v += s_part[g * NH + tid];
    s_cta[tid] = v;
  }
  if (cs > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
  if (rank == 0 && tid < NH) {
    double v = 0.0;
    for (int r = 0; r < cs; ++r) {
      const double* src = cs > 1 ? cluster.map_shared_rank(s_cta, r) : s_cta;
      v += src[tid];
    }
    int a, b;
    hess_entry<R>(tid, a, b);
    float* hm = L.hess + (size_t)item * R * R;
    hm[a * R + b] = (float)v;
    hm[b * R + a] = (float)v;
  }
  // No CTA leaves while rank 0 may still read its partial.
  if (cs > 1) cluster.sync();
}

// Dynamic shared memory of a CTA of `slice` keypoints: both sets' u16
// bins, or u32 wd bits in the exact-count mode.
inline size_t entry_bytes(int slice, bool exact) {
  return (size_t)2 * slice * (exact ? sizeof(uint32_t) : sizeof(uint16_t));
}

template <int R, bool EXACT>
int launch(const Level& L, int batch, int cluster, void* stream) {
  static gn::LaunchState state;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = gn::cluster_config(
      attr, batch, cluster, THREADS, entry_bytes(L.slice, EXACT), stream);
  return gn::launch_cluster(state, prelude_kernel<R, EXACT>, cfg, cluster,
                            L);
}

}  // namespace

// What the wrapper (ops/prelude.py::_PreludeArgs) passes for one level.
struct PreludeArgs {
  const void* windows;
  const void* coords;
  const void* jac;
  const void* idx_x;
  const void* idx_y;
  const void* key_index;
  const void* templates;
  long long tstride;
  const void* template_index;
  const void* transform;
  const void* fraction;
  int fstride;
  float fvalue;
  void* tmpl;
  void* jac_masked;
  void* hess;
  void* wd;
  void* mask;
  int batch, n, p, t, w, wt, margin, cluster, slice;
  int exact, k;  // the exact-count mode and its count (1..n)
  float cx, cy, inv_w, wf, rel_hi;
};

// The registers a thread of each form of a mode (exact: the exact-count
// mode, else the histogram mode) takes, its static shared memory, and the
// CTAs of the launch's block size an SM holds with `slice` keypoints a CTA
// (its dynamic shared memory, the kernel's limit raised to it first where
// it needs more, as a launch raises it): [0] for the similarity's R = 4,
// [1] for R = 8. Returns a cudaError_t.
extern "C" int vs_prelude_attributes(int slice, int exact, int* regs,
                                     int* static_smem, int* ctas) {
  void (*const forms[2])(const Level) = {
      exact ? prelude_kernel<4, true> : prelude_kernel<4, false>,
      exact ? prelude_kernel<8, true> : prelude_kernel<8, false>};
  for (int i = 0; i < 2; ++i) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, forms[i]);
    if (err != cudaSuccess) return (int)err;
    regs[i] = attr.numRegs;
    static_smem[i] = (int)attr.sharedSizeBytes;
    const size_t smem = entry_bytes(slice, exact != 0);
    if (smem > (size_t)attr.maxDynamicSharedSizeBytes) {
      err = cudaFuncSetAttribute(
          forms[i], cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&ctas[i], forms[i],
                                                        THREADS, smem);
    if (err != cudaSuccess) return (int)err;
  }
  return (int)cudaSuccess;
}

// One level for `batch` items; homography: 0 for the similarity's R = 4
// rows, 1 for the homography's R = 8; exact: the exact-count mode, which
// keeps k of each row. Returns a cudaError_t (cudaErrorInvalidValue for a
// shape the kernel does not take).
extern "C" int vs_level_prelude(const PreludeArgs* a, int homography,
                                void* stream) {
  if (a->batch < 1 || a->n < 1 || a->p < 5 || a->t < 1 || a->wt < 1 ||
      a->cluster < 1 || a->cluster > 8 || a->slice < 1 ||
      (long long)a->slice * a->cluster < a->n ||
      (long long)a->n * a->p * a->p > 0x7fffffffLL ||
      (a->exact && (a->k < 1 || a->k > a->n)))
    return (int)cudaErrorInvalidValue;
  const Level L{(const uint8_t*)a->windows,
                (const float*)a->coords,
                (const float*)a->jac,
                (const int32_t*)a->idx_x,
                (const int32_t*)a->idx_y,
                (const int64_t*)a->key_index,
                (const uint8_t*)a->templates,
                a->tstride,
                (const int64_t*)a->template_index,
                (const float*)a->transform,
                (const float*)a->fraction,
                a->fstride,
                a->fvalue,
                a->k,
                (float*)a->tmpl,
                (float*)a->jac_masked,
                (float*)a->hess,
                (float*)a->wd,
                (float*)a->mask,
                a->n,
                a->p,
                a->t,
                a->w,
                a->wt,
                a->margin,
                a->cluster,
                a->slice,
                a->cx,
                a->cy,
                a->inv_w,
                a->wf,
                a->rel_hi};
  if (a->exact)
    return homography ? launch<8, true>(L, a->batch, a->cluster, stream)
                      : launch<4, true>(L, a->batch, a->cluster, stream);
  return homography ? launch<8, false>(L, a->batch, a->cluster, stream)
                    : launch<4, false>(L, a->batch, a->cluster, stream);
}
