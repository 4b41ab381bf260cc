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
//   per (b, s) row: bins min(floor(wd), 256); k = floor(float(N) * f) in
//     float32 with f the item's keep fraction; the threshold the first bin
//     whose cumulative count reaches k, else 257; mask = bin <= threshold
//     (select.py:24-61 of the JAX package);
//   jac_masked[b, r, s, n] = jac[k, r, s, n] * (mask * 0.5) (similarity:
//     the ICA X/Y-set average folded in) or * mask (homography);
//   hess[b, i, j] = sum over s, n of (jac_i * mask) * jac_j, symmetric
//     (each product rounded to float32, the sum taken in float64);
//   wd[b, s, n], where its pointer is not null (a check's debug output).
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
// chunk (6 levels) or a 4K chunk (32 items, 7 levels) at 3.35 TB/s. Each
// tap lies N bytes from the next, so each costs its own 32-byte sector:
// counted as sectors the taps come to about 1.6 GB at the 1080p chunk.
//
// The design. An item is a thread-block cluster of 1-8 CTAs (the plan's
// cluster size, ops/prelude.py::launch_plan), CTA r taking keypoints
// [r slice, (r + 1) slice) of both sets, so a level of few items still
// spreads over the card:
//   - pass 1: a thread an entry (set-major within the slice), its position,
//     sample, template byte and wd; tmpl (and wd) go out, the entry's bin
//     stays in dynamic shared memory as u16, and an integer shared atomic
//     adds it to its set's 257-bin histogram (integer adds: the order does
//     not matter);
//   - merge: cluster.sync; every CTA sums the cluster's histograms through
//     DSMEM in rank order, and warp s scans set s's bins (9 a lane, a
//     shuffle scan of the lane sums, a ballot for the first bin that
//     reaches k);
//   - pass 2: a thread an entry again, the mask from its bin; jac_masked
//     goes out, and the R (R + 1) / 2 distinct Hessian entries accumulate
//     in registers, each float32 product (jac_i * mask) * jac_j added in
//     float64;
//   - Hessian: each warp by a butterfly of shuffles, each CTA over its
//     warps in order, the cluster's rank 0 over the CTAs in rank order
//     through DSMEM, all in float64, rounded to float32 once at the end;
//     a last cluster.sync keeps every CTA's shared memory alive until
//     rank 0 has read it.
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
constexpr int BINS = 257;          // 0..255 and the overflow bin 256
constexpr int BINS_PER_LANE = 9;   // 32 x 9 >= 257
constexpr int KEEP_ALL = BINS;     // the threshold when no bin reaches k

struct Level {
  const uint8_t* windows;          // (K, P, P, N)
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
  float* tmpl;                     // (B, 2, N)
  float* jac_masked;               // (B, R, 2, N)
  float* hess;                     // (B, R, R)
  float* wd;                       // (B, 2, N), or null
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

template <int R>
__global__ void __launch_bounds__(THREADS) prelude_kernel(const Level L) {
  constexpr int NH = R * (R + 1) / 2;  // distinct Hessian entries
  extern __shared__ uint16_t s_bin[];  // (2 x slice) entry bins
  __shared__ int s_hist[2 * BINS];     // this CTA's histograms
  __shared__ int s_count[2 * BINS];    // the cluster's
  __shared__ int s_thresh[2];
  __shared__ double s_warp[WARPS][NH];
  __shared__ double s_cta[NH];

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
  const uint8_t* win = L.windows + key * L.p * L.p * N;
  const float* fxk = L.coords + key * 4 * N;  // [xy][set][n]
  const int32_t* idx_x = L.idx_x + key * N;
  const int32_t* idx_y = L.idx_y + key * N;
  const uint8_t* frame =
      L.templates + (long long)L.template_index[item] * L.tstride;
  float q[R];
#pragma unroll
  for (int k = 0; k < R; ++k) q[k] = L.transform[(size_t)item * R + k];

  // Pass 1: position, sample, template byte, wd and its bin.
  for (int e = tid; e < 2 * cnt; e += THREADS) {
    const int s = e >= cnt;
    const int n = lo + (s ? e - cnt : e);
    const int ty = n / L.wt;
    const int tx = n - ty * L.wt;
    float rx, ry;
    warp_position<R>(q, fxk[s * N + n], fxk[2 * N + s * N + n],
                     (float)(tx * L.t - L.margin),
                     (float)(ty * L.t - L.margin), L, rx, ry);
    const float sample = lanczos_window_sample(win, rx, ry, L.p, N, n);
    const int idx = s ? idx_y[n] : idx_x[n];
    const int py = ty * L.t + idx / L.t;
    const int px = tx * L.t + idx % L.t;
    const float tv = (float)frame[(size_t)py * L.w + px];
    const float d = fabsf(sample - tv);
    const size_t out = ((size_t)item * 2 + s) * N + n;
    L.tmpl[out] = tv;
    if (L.wd != nullptr) L.wd[out] = d;
    const int bin = (int)fminf(floorf(d), (float)(BINS - 1));
    s_bin[e] = (uint16_t)bin;
    atomicAdd(&s_hist[s * BINS + bin], 1);
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
    const float f =
        L.fraction != nullptr ? L.fraction[(size_t)item * L.fstride]
                              : L.fvalue;
    const float k = floorf((float)N * f);
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
    int first = KEEP_ALL;
#pragma unroll
    for (int j = 0; j < BINS_PER_LANE; ++j) {
      run += own[j];
      if (first == KEEP_ALL && b0 + j < BINS && (float)run >= k)
        first = b0 + j;
    }
    const unsigned hit = __ballot_sync(gn::FULL, first != KEEP_ALL);
    const int thresh =
        hit ? __shfl_sync(gn::FULL, first, __ffs(hit) - 1) : KEEP_ALL;
    if (lane == 0) s_thresh[warp] = thresh;
  }
  __syncthreads();

  // Pass 2: the mask, jac_masked and the Hessian's partial sums.
  const int th0 = s_thresh[0];
  const int th1 = s_thresh[1];
  const float* jk = L.jac + key * R * 2 * N;
  float* jm_out = L.jac_masked + (size_t)item * R * 2 * N;
  double h[NH];
#pragma unroll
  for (int i = 0; i < NH; ++i) h[i] = 0.0;
  for (int e = tid; e < 2 * cnt; e += THREADS) {
    const int s = e >= cnt;
    const int n = lo + (s ? e - cnt : e);
    const float m = (int)s_bin[e] <= (s ? th1 : th0) ? 1.0f : 0.0f;
    const float mj = R == 4 ? m * 0.5f : m;
    float j[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      j[r] = jk[(size_t)(r * 2 + s) * N + n];
      jm_out[(size_t)(r * 2 + s) * N + n] = j[r] * mj;
    }
    int c = 0;
#pragma unroll
    for (int a = 0; a < R; ++a) {
      const float ja = j[a] * m;
#pragma unroll
      for (int b = a; b < R; ++b) h[c++] += (double)(ja * j[b]);
    }
  }

  // Hessian: warps, then the CTA's warps in order, then the cluster's CTAs
  // in rank order.
#pragma unroll
  for (int i = 0; i < NH; ++i) {
    double v = h[i];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v += __shfl_xor_sync(gn::FULL, v, off);
    h[i] = v;
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < NH; ++i) s_warp[warp][i] = h[i];
  }
  __syncthreads();
  if (tid < NH) {
    double v = 0.0;
    for (int w = 0; w < WARPS; ++w) v += s_warp[w][tid];
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
    int a = 0, rem = tid;
    while (rem >= R - a) {
      rem -= R - a;
      ++a;
    }
    const int b = a + rem;
    float* hb = L.hess + (size_t)item * R * R;
    hb[a * R + b] = (float)v;
    hb[b * R + a] = (float)v;
  }
  // No CTA leaves while rank 0 may still read its partial.
  if (cs > 1) cluster.sync();
}

template <int R>
int launch(const Level& L, int batch, int cluster, void* stream) {
  static gn::LaunchState state;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = gn::cluster_config(
      attr, batch, cluster, THREADS,
      (size_t)2 * L.slice * sizeof(uint16_t), stream);
  return gn::launch_cluster(state, prelude_kernel<R>, cfg, cluster, L);
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
  int batch, n, p, t, w, wt, margin, cluster, slice;
  float cx, cy, inv_w, wf, rel_hi;
};

// One level for `batch` items; homography: 0 for the similarity's R = 4
// rows, 1 for the homography's R = 8. Returns a cudaError_t
// (cudaErrorInvalidValue for a shape the kernel does not take).
extern "C" int vs_level_prelude(const PreludeArgs* a, int homography,
                                void* stream) {
  if (a->batch < 1 || a->n < 1 || a->p < 5 || a->t < 1 || a->wt < 1 ||
      a->cluster < 1 || a->cluster > 8 || a->slice < 1 ||
      (long long)a->slice * a->cluster < a->n)
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
                (float*)a->tmpl,
                (float*)a->jac_masked,
                (float*)a->hess,
                (float*)a->wd,
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
  return homography ? launch<8>(L, a->batch, a->cluster, stream)
                    : launch<4>(L, a->batch, a->cluster, stream);
}
