// One pyramid level's whole 8-DOF Gauss-Newton loop for the normalized
// homography. Each item (one alignment at one level) runs on one
// thread-block cluster of `cluster` CTAs; each CTA walks its own slice of
// the N keypoints.
//
// Replaces video_stabilizer_tpu/ops/pallas_gn.py::_gn8_kernel with
// _compose_h, _warp_corner_h and _tap_sample. Each iteration, as there (and
// as the XLA while_loop of models/homography_aligner.py::_align_level_h that
// both are held to):
//   1. warp both keypoint sets projectively in normalized coordinates:
//      nx = ((1+p0) u + p1 v) + p2, ny = (p3 u + (1+p4) v) + p5,
//      den = (p6 u + p7 v) + 1, x = (nx / den) W + W/2, y = (ny / den) W +
//      H/2, then the window offset and the clamp to [2, P - 3 - 1e-3];
//   2. take the weight-normalized Lanczos2 sample from the u8 keyframe
//      windows (bf16 products, f32 sums; lanczos_taps.cuh);
//   3. b = sum over both sets of jac_masked * (template - sample);
//   4. dt = Hinv b, no 1/width scaling and no 0.5 set average;
//   5. M = H(p) H(dt), every entry times 1/M22, -1 on the diagonal;
//   6. warp the four GN corners ((w-1, h-1) extent, normalized) by the new
//      p, and stop when none moved by the item's threshold, or at
//      max_iters.
// The keypoints come in normalized (u = (x - W/2) / W, v = (y - H/2) / W),
// which the XLA loop forms from the same pixel coordinates with the same
// expressions in every iteration. Outputs (p, converged, disp01, iters).
//
// The threshold is per item, as the Pallas kernel's traced SMEM operand
// becomes under vmap over the aligner's traced parameters: every CTA of an
// item's cluster reads the same value once at its start, so all of them
// still take the same stop decision.
//
// Eager PyTorch has no device loop whose trip count depends on data, so the
// loop lives here: each cluster carries its own item's trip count, and the
// host never syncs inside a level.
//
// Bound on an H100: bytes. chip_smoke.gn_bytes counts the 16 useful bytes
// of window taps per keypoint and set; read from the keypoint-major
// windows they cost 4 row reads, 3-4 32-byte sectors (below), and an
// iteration over all items of 4K level 0 still touches sectors of most of
// the keyframes' windows (18 keyframes x 21.2 MB), more than the 50 MB L2
// holds: level 0 is bound by those device-memory bytes. The
// coarse levels are bound by latency: a launch lasts as long as its
// slowest item's serial iterations. What the design does about each part
// of an iteration:
//   - Keypoints: N is split across the cluster (ops/gn8_solve.py::
//     launch_plan picks the cluster and block size). At 4K level 0 a level
//     has only 32 items (2 streams); one CTA per item left 100 of the 132
//     SMs idle, each CTA walking 2 x 20736 keypoints per iteration.
//   - Loop-invariant operands: the first iteration reads the slice's
//     origins, keypoints, template and masked Jacobian (96 B per keypoint)
//     from global memory and keeps the first `cached` keypoints of the
//     slice in dynamic shared memory; later iterations read those there
//     (a thread reads back only what it wrote, so no barrier guards the
//     cache) and the rest from L2 again. The item's Hinv rows, the corners
//     and the level constants live in registers. At 4K level 0 (N = 20736,
//     8 CTAs per item, 2592 keypoints each) a CTA caches 1024 keypoints:
//     98,304 bytes, so two CTAs fit on an SM; the other 1568 keypoints of
//     the slice still come from L2, as the window taps do.
//   - Reduction (gn_cluster.cuh): each warp's partial b goes to its CTA's
//     shared memory, in a buffer chosen by the iteration's parity; one
//     barrier per iteration; then every warp of every CTA sums all the
//     cluster's partials (through DSMEM) in one fixed order. So every warp
//     holds bit-identical b, runs the same tail and takes the same stop
//     decision, with no broadcast, no second barrier and no atomics: a
//     launch is deterministic. A last cluster.sync keeps every CTA's shared
//     memory alive until all have read it.
//   - Tail: lanes run the eight dt rows, the nine entries of H(p) H(dt)
//     and the four corners (two IEEE divisions each) in parallel; a
//     butterfly of shuffles takes the corner maximum.
// The windows are keypoint-major, (K, N, P, P) (kernel I writes them so):
// a keypoint's 4x4 taps are 4 rows of 4 bytes of its own window, one
// aligned 32-byte sector a row at P = 32, where the JAX package's (P, P, N)
// put each tap N bytes from the next, a sector each (lanczos_taps.cuh).
// Built with -fmad=false so the products and sums round where the JAX
// package's do; divisions are IEEE (no fast math). Only the order of the
// sum over keypoints differs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gn_cluster.cuh"
#include "lanczos_taps.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int NP = 8;
// Cached floats per keypoint: ox, oy, then per set u, v, template, and
// the 8 x 2 masked Jacobian rows.
constexpr int CACHE_FLOATS = 24;

struct Level {
  float width, cx, cy;
  float cu0, cu1, cu2, cu3;  // normalized GN corners
  float cv0, cv1, cv2, cv3;
  float rel_hi;
  int max_iters;
};

struct Plan {
  int cluster;  // CTAs per item
  int slice;    // keypoints per CTA (the last may hold fewer)
  int cached;   // leading keypoints of a slice kept in shared memory
};

// _warp_corner_h: projective warp of normalized GN corner i back to
// pixels.
__device__ __forceinline__ void warp_corner_h(const float p[NP], int i,
                                              const Level& lv, float& x,
                                              float& y) {
  const float cu = i == 0 ? lv.cu0 : i == 1 ? lv.cu1 : i == 2 ? lv.cu2
                                                              : lv.cu3;
  const float cv = i == 0 ? lv.cv0 : i == 1 ? lv.cv1 : i == 2 ? lv.cv2
                                                              : lv.cv3;
  const float nx = ((1.0f + p[0]) * cu + p[1] * cv) + p[2];
  const float ny = (p[3] * cu + (1.0f + p[4]) * cv) + p[5];
  const float den = (p[6] * cu + p[7] * cv) + 1.0f;
  x = nx / den * lv.width + lv.cx;
  y = ny / den * lv.width + lv.cy;
}

template <int THREADS>
__global__ void __launch_bounds__(THREADS) gn8_solve_kernel(
    const uint8_t* __restrict__ windows,    // (K, N, P, P)
    const int64_t* __restrict__ key_index,  // (B,)
    const float* __restrict__ tmpl,         // (B, 2, N)
    const float* __restrict__ jacm,         // (B, 8, 2, N)
    const float* __restrict__ hinv,         // (B, 8, 8)
    const float* __restrict__ u_all,        // (K, 2, N)
    const float* __restrict__ v_all,        // (K, 2, N)
    const float* __restrict__ ox,           // (N,)
    const float* __restrict__ oy,           // (N,)
    const float* __restrict__ p_init,       // (B, 8)
    const float* __restrict__ threshold,    // (B,)
    float* __restrict__ p_out,              // (B, 8)
    uint8_t* __restrict__ converged,        // (B,) bool
    float* __restrict__ disp01,             // (B,)
    int32_t* __restrict__ iters,            // (B,)
    int P, int N, Level lv, Plan pl) {
  constexpr int WARPS = THREADS / 32;
  extern __shared__ float s_cache[];  // (CACHE_FLOATS, cached)
  __shared__ float s_part[2][WARPS][NP];

  cg::cluster_group cluster = cg::this_cluster();
  const int cs = pl.cluster;
  const int rank = (int)cluster.block_rank();
  const int item = blockIdx.x / cs;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int lo = rank * pl.slice;
  const int len = max(0, min(N, lo + pl.slice) - lo);
  const int cached = pl.cached;

  const size_t key = (size_t)key_index[item];
  const uint8_t* win = windows + key * N * P * P;
  const float* uk = u_all + key * 2 * N;
  const float* vk = v_all + key * 2 * N;
  const float* tm = tmpl + (size_t)item * 2 * N;
  const float* jm = jacm + (size_t)item * 16 * N;

  // Loop state, the same in every thread of the cluster. Lane l holds Hinv
  // row l & 7, computes entry l % 9 of H(p) H(dt) and GN corner l & 3.
  const int row = lane & (NP - 1);
  const int entry = lane % 9;
  const int corner = lane & 3;
  float h[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) h[j] = hinv[(size_t)item * 64 + row * NP + j];
  float p[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) p[k] = p_init[NP * item + k];
  float c0x, c0y;
  warp_corner_h(p, corner, lv, c0x, c0y);
  float px = c0x, py = c0y;
  const float thr = threshold[item];
  int it = 0;
  bool conv = false;
  bool done = lv.max_iters <= 0;

  while (!done) {
    const float pa = 1.0f + p[0];
    const float pe = 1.0f + p[4];
    float acc[NP];
#pragma unroll
    for (int k = 0; k < NP; ++k) acc[k] = 0.0f;
    for (int j = tid; j < len; j += THREADS) {
      const int n = lo + j;
      float q[CACHE_FLOATS];
      if (j < cached && it > 0) {
#pragma unroll
        for (int f = 0; f < CACHE_FLOATS; ++f) q[f] = s_cache[f * cached + j];
      } else {
        q[0] = ox[n];
        q[1] = oy[n];
#pragma unroll
        for (int s = 0; s < 2; ++s) {
          q[2 + s] = uk[s * N + n];
          q[4 + s] = vk[s * N + n];
          q[6 + s] = tm[s * N + n];
        }
#pragma unroll
        for (int e = 0; e < 16; ++e) q[8 + e] = jm[(size_t)e * N + n];
        if (j < cached) {
#pragma unroll
          for (int f = 0; f < CACHE_FLOATS; ++f)
            s_cache[f * cached + j] = q[f];
        }
      }
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const float u = q[2 + s];
        const float v = q[4 + s];
        const float nx = (pa * u + p[1] * v) + p[2];
        const float ny = (p[3] * u + pe * v) + p[5];
        const float den = (p[6] * u + p[7] * v) + 1.0f;
        const float wx = nx / den * lv.width + lv.cx;
        const float wy = ny / den * lv.width + lv.cy;
        const float rx = clampf(wx - q[0], 2.0f, lv.rel_hi);
        const float ry = clampf(wy - q[1], 2.0f, lv.rel_hi);
        const float residual = q[6 + s] - lanczos_window_sample(
            win + (size_t)n * P * P, rx, ry, P);
#pragma unroll
        for (int k = 0; k < NP; ++k) acc[k] += q[8 + k * 2 + s] * residual;
      }
    }
    // b over the whole cluster, the same bits in every thread.
    float bv[NP];
    gn::cluster_sum<NP, WARPS>(cluster, cs, s_part[it & 1], acc, bv);
    // dt = Hinv b, row `row` in this lane, then to every lane.
    float dt_own = h[0] * bv[0];
#pragma unroll
    for (int j = 1; j < NP; ++j) dt_own = dt_own + h[j] * bv[j];
    float dt[NP];
#pragma unroll
    for (int k = 0; k < NP; ++k) dt[k] = __shfl_sync(gn::FULL, dt_own, k);
    // _compose_h: M = H(p) H(dt); lane `entry` forms M[entry / 3][entry %
    // 3], then every lane takes 1/M22 and the eight normalized entries.
    const int mi = entry / 3;
    const int mj = entry % 3;
    const float a0 = mi == 0 ? 1.0f + p[0] : mi == 1 ? p[3] : p[6];
    const float a1 = mi == 0 ? p[1] : mi == 1 ? 1.0f + p[4] : p[7];
    const float a2 = mi == 0 ? p[2] : mi == 1 ? p[5] : 1.0f;
    const float b0 = mj == 0 ? 1.0f + dt[0] : mj == 1 ? dt[1] : dt[2];
    const float b1 = mj == 0 ? dt[3] : mj == 1 ? 1.0f + dt[4] : dt[5];
    const float b2 = mj == 0 ? dt[6] : mj == 1 ? dt[7] : 1.0f;
    const float m_own = (a0 * b0 + a1 * b1) + a2 * b2;
    const float inv = 1.0f / __shfl_sync(gn::FULL, m_own, 8);
    float pn_own = m_own * inv;
    if (entry == 0 || entry == 4) pn_own = pn_own - 1.0f;
#pragma unroll
    for (int k = 0; k < NP; ++k) p[k] = __shfl_sync(gn::FULL, pn_own, k);
    float nx, ny;
    warp_corner_h(p, corner, lv, nx, ny);
    const float dx = nx - px;
    const float dy = ny - py;
    const float disp12 = gn::corner_max(sqrtf(dx * dx + dy * dy));
    px = nx;
    py = ny;
    ++it;
    conv = disp12 < thr;
    done = conv || it >= lv.max_iters;
  }
  // No CTA leaves while another may still read its partials.
  if (cs > 1) cluster.sync();

  if (rank == 0 && warp == 0) {
    const float dx = px - c0x;
    const float dy = py - c0y;
    const float d01 = gn::corner_max(sqrtf(dx * dx + dy * dy));
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < NP; ++k) p_out[NP * item + k] = p[k];
      converged[item] = conv;
      disp01[item] = d01;
      iters[item] = it;
    }
  }
}

// Launches the THREADS-thread instance as clusters of `cluster` CTAs.
template <int THREADS, typename... Args>
int launch(const cudaLaunchConfig_t& cfg, int cluster, Args... args) {
  static gn::LaunchState state;
  return gn::launch_cluster(state, gn8_solve_kernel<THREADS>, cfg, cluster,
                            args...);
}

}  // namespace

extern "C" int vs_gn8_solve(const void* windows, const void* key_index,
                            const void* tmpl, const void* jacm,
                            const void* hinv, const void* u, const void* v,
                            const void* ox, const void* oy,
                            const void* p_init, const void* threshold,
                            void* p_out, void* converged, void* disp01,
                            void* iters, int batch, int P, int N,
                            float width, float cx, float cy, float cu0,
                            float cu1, float cu2, float cu3, float cv0,
                            float cv1, float cv2, float cv3, float rel_hi,
                            int max_iters, int threads, int cluster,
                            int slice, int cached, void* stream) {
  if (batch < 1 || P < 5 || N < 1 || cluster < 1 || cluster > 8 ||
      slice < 1 || (long long)slice * cluster < N || cached < 0 ||
      cached > slice)
    return (int)cudaErrorInvalidValue;
  const Level lv{width, cx,  cy,  cu0, cu1,    cu2,      cu3,
                 cv0,   cv1, cv2, cv3, rel_hi, max_iters};
  const Plan pl{cluster, slice, cached};
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = gn::cluster_config(
      attr, batch, cluster, threads,
      (size_t)cached * CACHE_FLOATS * sizeof(float), stream);
#define VS_GN8_ARGS                                                         \
  cfg, cluster, (const uint8_t*)windows, (const int64_t*)key_index,         \
      (const float*)tmpl, (const float*)jacm, (const float*)hinv,           \
      (const float*)u, (const float*)v, (const float*)ox, (const float*)oy, \
      (const float*)p_init, (const float*)threshold, (float*)p_out,         \
      (uint8_t*)converged, (float*)disp01, (int32_t*)iters, P, N, lv, pl
  switch (threads) {
    case 256:
      return launch<256>(VS_GN8_ARGS);
    case 512:
      return launch<512>(VS_GN8_ARGS);
    default:
      return (int)cudaErrorInvalidValue;
  }
#undef VS_GN8_ARGS
}
