// One pyramid level's whole 4-DOF inverse-compositional Gauss-Newton loop,
// one thread block per item (an item is one alignment at one level).
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
//   5. stop when no GN corner moved by the threshold, or at max_iters.
// Outputs (t, converged, disp01, iters) as the Pallas kernel's row.
//
// Eager PyTorch has no device loop whose trip count depends on data, so the
// loop lives here: each block carries its own trip count, with no lockstep
// across items, and the host never syncs inside a level.
//
// Bound on an H100: bytes, and latency in practice. Only the <= 4x4 window
// taps that can carry Lanczos2 weight are read (the others add exact zeros),
// i.e. 16 of the P*P window bytes per keypoint and set; the windows of a
// level (5.3 MB per keyframe at 1080p level 0) stay in the 50 MB L2 across
// iterations. One block per item leaves most of each SM idle at the coarse
// levels; splitting N across a cluster with a DSMEM reduction is later work.
// Built with -fmad=false so the products and sums round where the JAX
// package's do.

#include <cuda_runtime.h>
#include <stdint.h>

#include "lanczos_taps.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;

struct Corners {
  float x[4], y[4];
};

// Centre-pivot warp of the four GN corners (imgproc.cpp:401-411).
__device__ Corners warp_corners(const float t[4], const float cxs[4],
                                const float cys[4], float cx, float cy) {
  Corners o;
  for (int i = 0; i < 4; ++i) {
    const float u = cxs[i] - cx;
    const float v = cys[i] - cy;
    o.x[i] = (1.0f + t[0]) * u - t[1] * v + cx + t[2];
    o.y[i] = t[1] * u + (1.0f + t[0]) * v + cy + t[3];
  }
  return o;
}

__device__ float max_move(const Corners& p, const Corners& q) {
  float d = 0.0f;
  for (int i = 0; i < 4; ++i) {
    const float dx = p.x[i] - q.x[i];
    const float dy = p.y[i] - q.y[i];
    d = fmaxf(d, sqrtf(dx * dx + dy * dy));
  }
  return d;
}

__global__ void __launch_bounds__(THREADS) gn_solve_kernel(
    const uint8_t* __restrict__ windows,  // (K, P, P, N)
    const int32_t* __restrict__ key_index,  // (B,)
    const float* __restrict__ tmpl,       // (B, 2, N)
    const float* __restrict__ jacm,       // (B, 4, 2, N)
    const float* __restrict__ hinv,       // (B, 4, 4)
    const float* __restrict__ fx,         // (K, 2, N)
    const float* __restrict__ fy,         // (K, 2, N)
    const float* __restrict__ ox,         // (N,)
    const float* __restrict__ oy,         // (N,)
    const float* __restrict__ t_init,     // (B, 4)
    float* __restrict__ t_out,            // (B, 4)
    int32_t* __restrict__ converged,      // (B,)
    float* __restrict__ disp01,           // (B,)
    int32_t* __restrict__ iters,          // (B,)
    int P, int N, float cx, float cy, float w_m1, float h_m1,
    float jac_scale, float rel_hi, float threshold, int max_iters) {
  const int item = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t key = (size_t)key_index[item];
  const uint8_t* win = windows + key * P * P * N;
  const float* fxk = fx + key * 2 * N;
  const float* fyk = fy + key * 2 * N;
  const float* tm = tmpl + (size_t)item * 2 * N;
  const float* jm = jacm + (size_t)item * 8 * N;

  __shared__ float s_t[4];
  __shared__ int s_done;
  __shared__ float s_red[4][WARPS];

  // Thread 0 alone carries the loop state.
  const float cxs[4] = {0.0f, w_m1, 0.0f, w_m1};
  const float cys[4] = {0.0f, 0.0f, h_m1, h_m1};
  float t[4];
  Corners c0, prev;
  int it = 0;
  bool conv = false;
  if (tid == 0) {
    for (int k = 0; k < 4; ++k) t[k] = s_t[k] = t_init[4 * item + k];
    c0 = warp_corners(t, cxs, cys, cx, cy);
    prev = c0;
    s_done = max_iters <= 0;
  }
  __syncthreads();

  while (!s_done) {
    const float a = s_t[0], b = s_t[1], tx = s_t[2], ty = s_t[3];
    // centre_to_ul, W*0.5 convention (imgproc.cpp:72-75).
    const float txu = tx - a * cx + b * cy;
    const float tyu = ty - b * cx - a * cy;
    float acc[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    for (int n = tid; n < N; n += THREADS) {
      const float oxn = ox[n];
      const float oyn = oy[n];
      for (int s = 0; s < 2; ++s) {
        const float fxv = fxk[s * N + n];
        const float fyv = fyk[s * N + n];
        const float wxp = (1.0f + a) * fxv - b * fyv + txu;
        const float wyp = b * fxv + (1.0f + a) * fyv + tyu;
        const float rx = clampf(wxp - oxn, 2.0f, rel_hi);
        const float ry = clampf(wyp - oyn, 2.0f, rel_hi);
        const float residual =
            tm[s * N + n] - lanczos_window_sample(win, rx, ry, P, N, n);
        for (int k = 0; k < 4; ++k) acc[k] += jm[(k * 2 + s) * N + n] * residual;
      }
    }
    // Block reduction of the 4-vector b.
    const int lane = tid & 31;
    const int warp = tid >> 5;
    for (int k = 0; k < 4; ++k) {
      float v = acc[k];
      for (int off = 16; off > 0; off >>= 1)
        v += __shfl_down_sync(0xffffffffu, v, off);
      if (lane == 0) s_red[k][warp] = v;
    }
    __syncthreads();
    if (tid == 0) {
      float bv[4];
      for (int k = 0; k < 4; ++k) {
        float v = 0.0f;
        for (int w = 0; w < WARPS; ++w) v += s_red[k][w];
        bv[k] = v;
      }
      const float* hi = hinv + (size_t)item * 16;
      float dt[4];
      for (int k = 0; k < 4; ++k)
        dt[k] = ((hi[4 * k] * bv[0] + hi[4 * k + 1] * bv[1]) +
                 hi[4 * k + 2] * bv[2]) + hi[4 * k + 3] * bv[3];
      // compose(delta, t), delta first (alignment.cpp:639).
      const float p1 = 1.0f + dt[0] * jac_scale;
      const float q1 = dt[1] * jac_scale;
      const float p2 = 1.0f + t[0];
      const float q2 = t[1];
      const float tn[4] = {p2 * p1 - q2 * q1 - 1.0f, p2 * q1 + q2 * p1,
                           p2 * dt[2] - q2 * dt[3] + t[2],
                           q2 * dt[2] + p2 * dt[3] + t[3]};
      const Corners nc = warp_corners(tn, cxs, cys, cx, cy);
      const float disp12 = max_move(nc, prev);
      for (int k = 0; k < 4; ++k) t[k] = s_t[k] = tn[k];
      prev = nc;
      ++it;
      conv = disp12 < threshold;
      s_done = conv || it >= max_iters;
    }
    __syncthreads();
  }

  if (tid == 0) {
    for (int k = 0; k < 4; ++k) t_out[4 * item + k] = t[k];
    converged[item] = conv ? 1 : 0;
    disp01[item] = max_move(prev, c0);
    iters[item] = it;
  }
}

}  // namespace

extern "C" int vs_gn_solve(const void* windows, const void* key_index,
                           const void* tmpl, const void* jacm,
                           const void* hinv, const void* fx, const void* fy,
                           const void* ox, const void* oy, const void* t_init,
                           void* t_out, void* converged, void* disp01,
                           void* iters, int batch, int P, int N, float cx,
                           float cy, float w_m1, float h_m1, float jac_scale,
                           float rel_hi, float threshold, int max_iters,
                           void* stream) {
  if (batch < 1 || P < 5 || N < 1) return (int)cudaErrorInvalidValue;
  gn_solve_kernel<<<batch, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)windows, (const int32_t*)key_index, (const float*)tmpl,
      (const float*)jacm, (const float*)hinv, (const float*)fx,
      (const float*)fy, (const float*)ox, (const float*)oy,
      (const float*)t_init, (float*)t_out, (int32_t*)converged,
      (float*)disp01, (int32_t*)iters, P, N, cx, cy, w_m1, h_m1, jac_scale,
      rel_hi, threshold, max_iters);
  return (int)cudaGetLastError();
}
