// One pyramid level's whole 8-DOF Gauss-Newton loop for the normalized
// homography, one thread block per item (an item is one alignment at one
// level).
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
//      p, and stop when none moved by the threshold, or at max_iters.
// The keypoints come in normalized (u = (x - W/2) / W, v = (y - H/2) / W),
// which the XLA loop forms from the same pixel coordinates with the same
// expressions in every iteration. Outputs (p, converged, disp01, iters).
//
// Eager PyTorch has no device loop whose trip count depends on data, so the
// loop lives here: each block carries its own trip count, and the host
// never syncs inside a level.
//
// Bound on an H100: bytes. Per item and iteration the block reads the
// masked Jacobian (64 B per keypoint), the template, the keypoints and the
// <= 4x4 window taps with Lanczos2 weight (32 B per keypoint over both
// sets); at 4K level 0 that is about 3 MB per item-iteration, held in the
// 50 MB L2 across iterations. With 2 streams a level has only 32 items, so
// 32 blocks run on 132 SMs and each walks 2 x 20736 keypoints per iteration
// at level 0; splitting N across a cluster with a DSMEM reduction of b is
// later work. 512 threads per block give each SM more loads in flight than
// kernel B's 256. Built with -fmad=false so the products and sums round
// where the JAX package's do; divisions are IEEE (no fast math).

#include <cuda_runtime.h>
#include <stdint.h>

#include "lanczos_taps.cuh"

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int NP = 8;

struct Corners {
  float x[4], y[4];
};

// _warp_corner_h: projective warp of the four normalized corners back to
// pixels.
__device__ Corners warp_corners_h(const float p[NP], const float cu[4],
                                  const float cv[4], float width, float cx,
                                  float cy) {
  Corners o;
  for (int i = 0; i < 4; ++i) {
    const float nx = ((1.0f + p[0]) * cu[i] + p[1] * cv[i]) + p[2];
    const float ny = (p[3] * cu[i] + (1.0f + p[4]) * cv[i]) + p[5];
    const float den = (p[6] * cu[i] + p[7] * cv[i]) + 1.0f;
    o.x[i] = nx / den * width + cx;
    o.y[i] = ny / den * width + cy;
  }
  return o;
}

__device__ float max_move(const Corners& a, const Corners& b) {
  float d = 0.0f;
  for (int i = 0; i < 4; ++i) {
    const float dx = a.x[i] - b.x[i];
    const float dy = a.y[i] - b.y[i];
    d = fmaxf(d, sqrtf(dx * dx + dy * dy));
  }
  return d;
}

// _compose_h: compose(dt, p) = H(p) @ H(dt), normalized by 1/M22.
__device__ void compose_h(const float dt[NP], const float p[NP],
                          float out[NP]) {
  const float a[3][3] = {{1.0f + p[0], p[1], p[2]},
                         {p[3], 1.0f + p[4], p[5]},
                         {p[6], p[7], 1.0f}};
  const float b[3][3] = {{1.0f + dt[0], dt[1], dt[2]},
                         {dt[3], 1.0f + dt[4], dt[5]},
                         {dt[6], dt[7], 1.0f}};
  float m[3][3];
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      m[i][j] = (a[i][0] * b[0][j] + a[i][1] * b[1][j]) + a[i][2] * b[2][j];
  const float inv = 1.0f / m[2][2];
  out[0] = m[0][0] * inv - 1.0f;
  out[1] = m[0][1] * inv;
  out[2] = m[0][2] * inv;
  out[3] = m[1][0] * inv;
  out[4] = m[1][1] * inv - 1.0f;
  out[5] = m[1][2] * inv;
  out[6] = m[2][0] * inv;
  out[7] = m[2][1] * inv;
}

struct Level {
  float width, cx, cy;
  float cu[4], cv[4];  // normalized GN corners
  float rel_hi, threshold;
  int max_iters;
};

__global__ void __launch_bounds__(THREADS) gn8_solve_kernel(
    const uint8_t* __restrict__ windows,    // (K, P, P, N)
    const int32_t* __restrict__ key_index,  // (B,)
    const float* __restrict__ tmpl,         // (B, 2, N)
    const float* __restrict__ jacm,         // (B, 8, 2, N)
    const float* __restrict__ hinv,         // (B, 8, 8)
    const float* __restrict__ u_all,        // (K, 2, N)
    const float* __restrict__ v_all,        // (K, 2, N)
    const float* __restrict__ ox,           // (N,)
    const float* __restrict__ oy,           // (N,)
    const float* __restrict__ p_init,       // (B, 8)
    float* __restrict__ p_out,              // (B, 8)
    int32_t* __restrict__ converged,        // (B,)
    float* __restrict__ disp01,             // (B,)
    int32_t* __restrict__ iters,            // (B,)
    int P, int N, Level lv) {
  const int item = blockIdx.x;
  const int tid = threadIdx.x;
  const size_t key = (size_t)key_index[item];
  const uint8_t* win = windows + key * P * P * N;
  const float* uk = u_all + key * 2 * N;
  const float* vk = v_all + key * 2 * N;
  const float* tm = tmpl + (size_t)item * 2 * N;
  const float* jm = jacm + (size_t)item * 16 * N;

  __shared__ float s_p[NP];
  __shared__ int s_done;
  __shared__ float s_red[NP][WARPS];

  // Thread 0 alone carries the loop state.
  float p[NP];
  Corners c0, prev;
  int it = 0;
  bool conv = false;
  if (tid == 0) {
    for (int k = 0; k < NP; ++k) p[k] = s_p[k] = p_init[NP * item + k];
    c0 = warp_corners_h(p, lv.cu, lv.cv, lv.width, lv.cx, lv.cy);
    prev = c0;
    s_done = lv.max_iters <= 0;
  }
  __syncthreads();

  while (!s_done) {
    float q[NP];
    for (int k = 0; k < NP; ++k) q[k] = s_p[k];
    const float pa = 1.0f + q[0];
    const float pe = 1.0f + q[4];
    float acc[NP];
    for (int k = 0; k < NP; ++k) acc[k] = 0.0f;
    for (int n = tid; n < N; n += THREADS) {
      const float oxn = ox[n];
      const float oyn = oy[n];
      for (int s = 0; s < 2; ++s) {
        const float u = uk[s * N + n];
        const float v = vk[s * N + n];
        const float nx = (pa * u + q[1] * v) + q[2];
        const float ny = (q[3] * u + pe * v) + q[5];
        const float den = (q[6] * u + q[7] * v) + 1.0f;
        const float wx = nx / den * lv.width + lv.cx;
        const float wy = ny / den * lv.width + lv.cy;
        const float rx = clampf(wx - oxn, 2.0f, lv.rel_hi);
        const float ry = clampf(wy - oyn, 2.0f, lv.rel_hi);
        const float residual =
            tm[s * N + n] - lanczos_window_sample(win, rx, ry, P, N, n);
        for (int k = 0; k < NP; ++k)
          acc[k] += jm[(k * 2 + s) * N + n] * residual;
      }
    }
    // Block reduction of the 8-vector b.
    const int lane = tid & 31;
    const int warp = tid >> 5;
    for (int k = 0; k < NP; ++k) {
      float val = acc[k];
      for (int off = 16; off > 0; off >>= 1)
        val += __shfl_down_sync(0xffffffffu, val, off);
      if (lane == 0) s_red[k][warp] = val;
    }
    __syncthreads();
    if (tid == 0) {
      float bv[NP];
      for (int k = 0; k < NP; ++k) {
        float val = 0.0f;
        for (int w = 0; w < WARPS; ++w) val += s_red[k][w];
        bv[k] = val;
      }
      const float* hi = hinv + (size_t)item * NP * NP;
      float dt[NP];
      for (int k = 0; k < NP; ++k) {
        float val = hi[NP * k] * bv[0];
        for (int j = 1; j < NP; ++j) val = val + hi[NP * k + j] * bv[j];
        dt[k] = val;
      }
      float pn[NP];
      compose_h(dt, p, pn);
      const Corners nc =
          warp_corners_h(pn, lv.cu, lv.cv, lv.width, lv.cx, lv.cy);
      const float disp12 = max_move(nc, prev);
      for (int k = 0; k < NP; ++k) p[k] = s_p[k] = pn[k];
      prev = nc;
      ++it;
      conv = disp12 < lv.threshold;
      s_done = conv || it >= lv.max_iters;
    }
    __syncthreads();
  }

  if (tid == 0) {
    for (int k = 0; k < NP; ++k) p_out[NP * item + k] = p[k];
    converged[item] = conv ? 1 : 0;
    disp01[item] = max_move(prev, c0);
    iters[item] = it;
  }
}

}  // namespace

extern "C" int vs_gn8_solve(const void* windows, const void* key_index,
                            const void* tmpl, const void* jacm,
                            const void* hinv, const void* u, const void* v,
                            const void* ox, const void* oy,
                            const void* p_init, void* p_out, void* converged,
                            void* disp01, void* iters, int batch, int P,
                            int N, float width, float cx, float cy,
                            float cu0, float cu1, float cu2, float cu3,
                            float cv0, float cv1, float cv2, float cv3,
                            float rel_hi, float threshold, int max_iters,
                            void* stream) {
  if (batch < 1 || P < 5 || N < 1) return (int)cudaErrorInvalidValue;
  Level lv;
  lv.width = width;
  lv.cx = cx;
  lv.cy = cy;
  const float cus[4] = {cu0, cu1, cu2, cu3};
  const float cvs[4] = {cv0, cv1, cv2, cv3};
  for (int i = 0; i < 4; ++i) {
    lv.cu[i] = cus[i];
    lv.cv[i] = cvs[i];
  }
  lv.rel_hi = rel_hi;
  lv.threshold = threshold;
  lv.max_iters = max_iters;
  gn8_solve_kernel<<<batch, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)windows, (const int32_t*)key_index, (const float*)tmpl,
      (const float*)jacm, (const float*)hinv, (const float*)u,
      (const float*)v, (const float*)ox, (const float*)oy,
      (const float*)p_init, (float*)p_out, (int32_t*)converged,
      (float*)disp01, (int32_t*)iters, P, N, lv);
  return (int)cudaGetLastError();
}
