// One pyramid level's whole 4-DOF inverse-compositional Gauss-Newton loop.
// Each item (one alignment at one level) runs on one thread-block cluster
// of `cluster` CTAs; each CTA walks its own slice of the N keypoints.
//
// Replaces video_stabilizer_tpu/ops/pallas_gn.py::_gn_kernel with
// _tap_sample. Each iteration, as there (and as the XLA while_loop of
// models/aligner.py::_align_level that both are held to):
//   1. warp both keypoint sets by the current transform (centre pivot
//      W*0.5) and clamp the window positions to [2, P - 3 - 1e-3];
//   2. take the weight-normalized Lanczos2 sample from the u8 keyframe
//      windows: products (window * wy) then (* wx), each rounded to bf16,
//      summed in f32;
//   3. b = sum over both sets of jac_masked * (template - sample);
//   4. dt = Hinv b, A and B of dt scaled by 1/width, composed delta first;
//   5. stop when no GN corner moved by the item's threshold, or at
//      max_iters.
// Outputs (t, converged, disp01, iters) as the Pallas kernel's row.
//
// The threshold is per item: the Pallas kernel takes it as a traced SMEM
// operand, which vmap over the aligner's traced parameters
// (models/aligner.py::DynAlignParams) turns into one value per item, so a
// parameter sweep runs all its combos in one launch. Every CTA of an
// item's cluster reads the same value once at its start, so all of them
// still take the same stop decision.
//
// Fixed-iteration mode (fixed_iters >= 0; models/aligner.py:387-407 of the
// JAX package, which runs it as an unrolled XLA loop, not in Pallas): every
// item runs exactly fixed_iters iterations, with no early stop and no
// max_iters cap; converged means the last step moved no corner by the
// item's threshold (with no step, a step of 0); disp01 is taken from the
// final corners and iters is fixed_iters. Every CTA of a cluster counts the
// same iterations, so the stop decision stays the same in all of them.
//
// Eager PyTorch has no device loop whose trip count depends on data, so the
// loop lives here: each cluster carries its own item's trip count, with no
// lockstep across items, and the host never syncs inside a level.
//
// Bound on an H100: bytes. chip_smoke.gn_bytes counts the 16 useful bytes
// of window taps per keypoint and set; read from the keypoint-major
// windows they cost 4 row reads, 3-4 32-byte sectors (below), and an
// iteration over all items of 1080p level 0 still touches sectors of most
// of the keyframes' windows (72 keyframes x 5.3 MB), more than the 50 MB
// L2 holds: level 0 is bound by those device-memory bytes. The
// coarse levels are bound by latency: a launch lasts as long as its
// slowest item's serial iterations. What the design does about each part
// of an iteration:
//   - Keypoints: N is split across the cluster (ops/gn_solve.py::
//     launch_plan picks the cluster size; a block is 256 threads), so one
//     item's iteration is spread over up to 8 SMs, and a level of few
//     items still fills the card.
//   - Loop-invariant operands: the first iteration reads the slice's
//     origins, keypoints, template and masked Jacobian (64 B per keypoint)
//     from global memory and keeps them in dynamic shared memory; every
//     later iteration reads them there (a thread reads back only what it
//     wrote, so no barrier guards the cache). The item's Hinv rows, the
//     corners and the level constants live in registers. Only the 16
//     window taps per keypoint and set come from L2 in every iteration.
//     At 1080p level 0 (N = 5184, 8 CTAs per item) a CTA caches 648
//     keypoints: 41,472 bytes.
//   - Reduction (gn_cluster.cuh): each warp's partial b goes to its CTA's
//     shared memory, in a buffer chosen by the iteration's parity; one
//     barrier per iteration; then every warp of every CTA sums all the
//     cluster's partials (through DSMEM) in one fixed order. So every warp
//     holds bit-identical b, runs the same tail and takes the same stop
//     decision, with no broadcast, no second barrier and no atomics: a
//     launch is deterministic. A last cluster.sync keeps every CTA's shared
//     memory alive until all have read it.
//   - Tail: lanes run the four dt rows and the four corners in parallel;
//     a butterfly of shuffles takes the corner maximum.
// The windows are keypoint-major, (K, N, P, P) (kernel I writes them so):
// a keypoint's 4x4 taps are 4 rows of 4 bytes of its own window, one
// aligned 32-byte sector a row at P = 32, where the JAX package's (P, P, N)
// put each tap N bytes from the next, a sector each (lanczos_taps.cuh).
// Built with -fmad=false so the products and sums round where the JAX
// package's do; only the order of the sum over keypoints differs.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "gn_cluster.cuh"
#include "lanczos_taps.cuh"

namespace cg = cooperative_groups;

namespace {

// One block size: ptxas spilled 12 bytes in the 128- and 512-thread
// instances of this loop, none at 256.
constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int NP = 4;
// Cached floats per keypoint: ox, oy, then per set fx, fy, template, and
// the 4 x 2 masked Jacobian rows.
constexpr int CACHE_FLOATS = 16;

struct Level {
  float cx, cy, w_m1, h_m1, jac_scale, rel_hi;
  int max_iters;
  int fixed_iters;  // -1: converge or stop at max_iters
};

struct Plan {
  int cluster;  // CTAs per item
  int slice;    // keypoints per CTA (the last may hold fewer)
  int cached;   // leading keypoints of a slice kept in shared memory
};

// Centre-pivot warp of GN corner i (imgproc.cpp:401-411); corners are
// (0, 0), (w-1, 0), (0, h-1), (w-1, h-1).
__device__ __forceinline__ void warp_corner(const float t[NP], int i,
                                            const Level& lv, float& x,
                                            float& y) {
  const float u = ((i & 1) ? lv.w_m1 : 0.0f) - lv.cx;
  const float v = ((i & 2) ? lv.h_m1 : 0.0f) - lv.cy;
  x = (1.0f + t[0]) * u - t[1] * v + lv.cx + t[2];
  y = t[1] * u + (1.0f + t[0]) * v + lv.cy + t[3];
}

__global__ void __launch_bounds__(THREADS) gn_solve_kernel(
    const uint8_t* __restrict__ windows,  // (K, N, P, P)
    const int64_t* __restrict__ key_index,  // (B,)
    const float* __restrict__ tmpl,       // (B, 2, N)
    const float* __restrict__ jacm,       // (B, 4, 2, N)
    const float* __restrict__ hinv,       // (B, 4, 4)
    const float* __restrict__ fx,         // (K, 2, N)
    const float* __restrict__ fy,         // (K, 2, N)
    const float* __restrict__ ox,         // (N,)
    const float* __restrict__ oy,         // (N,)
    const float* __restrict__ t_init,     // (B, 4)
    const float* __restrict__ threshold,  // (B,)
    float* __restrict__ t_out,            // (B, 4)
    uint8_t* __restrict__ converged,      // (B,) bool
    float* __restrict__ disp01,           // (B,)
    int32_t* __restrict__ iters,          // (B,)
    int P, int N, Level lv, Plan pl) {
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
  const float* fxk = fx + key * 2 * N;
  const float* fyk = fy + key * 2 * N;
  const float* tm = tmpl + (size_t)item * 2 * N;
  const float* jm = jacm + (size_t)item * 8 * N;

  // Loop state, the same in every thread of the cluster. Lane l holds Hinv
  // row l & 3 and GN corner l & 3.
  const int row = lane & (NP - 1);
  float h[NP];
#pragma unroll
  for (int j = 0; j < NP; ++j) h[j] = hinv[(size_t)item * 16 + row * NP + j];
  float t[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) t[k] = t_init[NP * item + k];
  float c0x, c0y;
  warp_corner(t, row, lv, c0x, c0y);
  float px = c0x, py = c0y;
  const float thr = threshold[item];
  const bool fixed = lv.fixed_iters >= 0;
  int it = 0;
  bool conv = fixed && 0.0f < thr;
  bool done = fixed ? lv.fixed_iters <= 0 : lv.max_iters <= 0;

  while (!done) {
    const float a = t[0], b = t[1], tx = t[2], ty = t[3];
    // centre_to_ul, W*0.5 convention (imgproc.cpp:72-75).
    const float txu = tx - a * lv.cx + b * lv.cy;
    const float tyu = ty - b * lv.cx - a * lv.cy;
    float acc[NP] = {0.0f, 0.0f, 0.0f, 0.0f};
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
          q[2 + s] = fxk[s * N + n];
          q[4 + s] = fyk[s * N + n];
          q[6 + s] = tm[s * N + n];
        }
#pragma unroll
        for (int e = 0; e < 8; ++e) q[8 + e] = jm[(size_t)e * N + n];
        if (j < cached) {
#pragma unroll
          for (int f = 0; f < CACHE_FLOATS; ++f)
            s_cache[f * cached + j] = q[f];
        }
      }
#pragma unroll
      for (int s = 0; s < 2; ++s) {
        const float fxv = q[2 + s];
        const float fyv = q[4 + s];
        const float wxp = (1.0f + a) * fxv - b * fyv + txu;
        const float wyp = b * fxv + (1.0f + a) * fyv + tyu;
        const float rx = clampf(wxp - q[0], 2.0f, lv.rel_hi);
        const float ry = clampf(wyp - q[1], 2.0f, lv.rel_hi);
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
    const float dt_own =
        ((h[0] * bv[0] + h[1] * bv[1]) + h[2] * bv[2]) + h[3] * bv[3];
    float dt[NP];
#pragma unroll
    for (int k = 0; k < NP; ++k) dt[k] = __shfl_sync(gn::FULL, dt_own, k);
    // compose(delta, t), delta first (alignment.cpp:639).
    const float p1 = 1.0f + dt[0] * lv.jac_scale;
    const float q1 = dt[1] * lv.jac_scale;
    const float p2 = 1.0f + t[0];
    const float q2 = t[1];
    const float tn[NP] = {p2 * p1 - q2 * q1 - 1.0f, p2 * q1 + q2 * p1,
                          p2 * dt[2] - q2 * dt[3] + t[2],
                          q2 * dt[2] + p2 * dt[3] + t[3]};
    float nx, ny;
    warp_corner(tn, row, lv, nx, ny);
    const float dx = nx - px;
    const float dy = ny - py;
    const float disp12 = gn::corner_max(sqrtf(dx * dx + dy * dy));
#pragma unroll
    for (int k = 0; k < NP; ++k) t[k] = tn[k];
    px = nx;
    py = ny;
    ++it;
    conv = disp12 < thr;
    done = fixed ? it >= lv.fixed_iters : conv || it >= lv.max_iters;
  }
  // No CTA leaves while another may still read its partials.
  if (cs > 1) cluster.sync();

  if (rank == 0 && warp == 0) {
    const float dx = px - c0x;
    const float dy = py - c0y;
    const float d01 = gn::corner_max(sqrtf(dx * dx + dy * dy));
    if (lane == 0) {
#pragma unroll
      for (int k = 0; k < NP; ++k) t_out[NP * item + k] = t[k];
      converged[item] = conv;
      disp01[item] = d01;
      iters[item] = it;
    }
  }
}

}  // namespace

extern "C" int vs_gn_solve(const void* windows, const void* key_index,
                           const void* tmpl, const void* jacm,
                           const void* hinv, const void* fx, const void* fy,
                           const void* ox, const void* oy, const void* t_init,
                           const void* threshold, void* t_out,
                           void* converged, void* disp01, void* iters,
                           int batch, int P, int N, float cx, float cy,
                           float w_m1, float h_m1, float jac_scale,
                           float rel_hi, int max_iters, int fixed_iters,
                           int threads, int cluster, int slice, int cached,
                           void* stream) {
  if (batch < 1 || P < 5 || N < 1 || threads != THREADS || cluster < 1 ||
      cluster > 8 || slice < 1 || (long long)slice * cluster < N ||
      cached < 0 || cached > slice)
    return (int)cudaErrorInvalidValue;
  const Level lv{cx, cy, w_m1, h_m1, jac_scale, rel_hi, max_iters,
                 fixed_iters};
  const Plan pl{cluster, slice, cached};
  static gn::LaunchState state;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = gn::cluster_config(
      attr, batch, cluster, THREADS,
      (size_t)cached * CACHE_FLOATS * sizeof(float), stream);
  return gn::launch_cluster(
      state, gn_solve_kernel, cfg, cluster, (const uint8_t*)windows,
      (const int64_t*)key_index, (const float*)tmpl, (const float*)jacm,
      (const float*)hinv, (const float*)fx, (const float*)fy,
      (const float*)ox, (const float*)oy, (const float*)t_init,
      (const float*)threshold, (float*)t_out, (uint8_t*)converged,
      (float*)disp01, (int32_t*)iters, P, N, lv, pl);
}
