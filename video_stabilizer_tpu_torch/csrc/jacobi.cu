// The regularized pseudo-inverse of the GN Hessian through fixed-sweep
// Jacobi: kernel E of the port.
//
// Replaces video_stabilizer_tpu/ops/linalg.py::regularized_pinv_sym4 (with
// eigh_sym :37, its round-robin order :70-106 and _eigh_sym_cyclic :140),
// Python loops that XLA unrolls into one fused program (not a Pallas
// kernel). Eager PyTorch runs each Givens rotation of the plain version
// (ops/linalg.py::regularized_pinv_sym4_plain) as a dozen kernels: about
// 1,140 kernels a 4x4 call and 1,870 an 8x8 one. Here a call is one launch.
//
// Contract: B float32 matrices (B, n, n) contiguous, n = 4 or 8; out the
// same shape. Per matrix A (not assumed symmetric: only a[p][q] feeds an
// angle, and every rotation touches the whole rows and columns):
//   1. 6 sweeps of Jacobi rotations (`sweeps`), V = I at the start. Each rotation of
//      the pair (p, q): phi = 0.5 * atan2(2 a[p][q], (a[p][p] - a[q][q]) +
//      FLT_MIN), c = cos(phi), s = sin(phi); rows p, q of A become c*r_p +
//      s*r_q and (-s)*r_p + c*r_q; then the same for the columns of A and
//      of V.
//        n = 4: CYCLIC order, pairs (0,1), (0,2), ..., (2,3), rows then
//               columns of one pair before the next pair's angle.
//        n = 8: ROUND-ROBIN order, 7 rounds of 4 disjoint pairs (RR8
//               below); a round takes all 4 angles first, then rotates the
//               rows of every pair, then the columns of A, then of V.
//   2. w = diag(A); w_max, w_min (a NaN wins, as torch.amax does);
//      cond = w_max / (w_min + 1e-10); lam = tikhonov * w_max if cond >
//      cond_threshold, else 0; cutoff = max(w_max + lam, 0) * 1e-7 (NaN
//      stays NaN); inv_w = 1 / (w + lam) where w + lam > cutoff, else 0.
//   3. out[i][j] = sum_k (V[i][k] * inv_w[k]) * V[j][k].
//
// Every operation rounds where the plain version's torch kernel does on
// the card: products, sums and quotients are round-to-nearest intrinsics,
// so nothing is contracted into an FMA whatever the flags; atan2f, cosf
// and sinf are the CUDA math library's, which torch's atan2, cos and sin
// kernels call for float32. The sum of step 3 follows torch's CUDA
// reduction over that axis: each of the block's rows of threads takes the
// products k and k + 4, adds them to the reduction's 0, and the rows are
// summed as a tree, (p0 + p2) + (p1 + p3) for n = 4 and ((p0 + p4) + (p2 +
// p6)) + ((p1 + p5) + (p3 + p7)) for n = 8. chip_smoke.py phase E holds
// the kernel to the plain version on the card bit for bit.
//
// Bound on an H100: the work is tiny (a 1080p chunk's level is 128
// matrices, 16 KB and about 0.5 MFLOP); what bounds a call is one matrix's
// chain of dependent rotations: 36 for n = 4, 42 rounds for n = 8, each an
// atan2, a cos and a sin on the path. The 4 rotations of a round are
// independent (all 4 angles come from the round's starting A), so the 8x8
// chain is 42 rotation steps deep, not 168. The design:
//   - n = 4: one thread owns one matrix, A and V in registers (every index
//     a compile-time constant once the pair loops unroll), blocks of 32
//     threads, nothing shared between threads.
//   - n = 8: one warp owns one matrix, WARPS8 matrices a block, A and V in
//     shared memory. In a round lane l owns the unit (pair l / 8, index
//     j = l % 8): every lane takes its pair's angle from the round's A (the
//     8 lanes of a pair compute the same bits, so the 4 pairs' atan2, cos
//     and sin run as one SIMT chain), rotates a[p][j] and a[q][j] (the
//     rows), then, after a __syncwarp, a[j][p], a[j][q], v[j][p] and
//     v[j][q] (the columns). The 4 pairs are disjoint, so each element of
//     a phase is written by one lane, from the old values it read itself.
//     The round loop stays rolled: the body is one round's code. The tail
//     gives each lane 2 of the 64 outputs.
// chip_smoke.py measures the 4x4 chain (one matrix alone) beside the
// kernel's time, and bounds the 8x8 form by 42 of its rotations.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int THREADS = 32;  // n = 4: one matrix a thread
constexpr int WARPS8 = 4;    // n = 8: one matrix a warp, 4 warps a block
constexpr float TINY = 1.17549435e-38f;  // FLT_MIN, finfo(float32).tiny

// The rounds of n = 8: ops/linalg.py::_round_robin_rounds(8), pairs (p, q)
// with p < q. tests/test_torch_linalg_kernel.py reads this table.
__constant__ int RR8[7][4][2] = {
    {{0, 7}, {1, 6}, {2, 5}, {3, 4}},
    {{0, 6}, {5, 7}, {1, 4}, {2, 3}},
    {{0, 5}, {4, 6}, {3, 7}, {1, 2}},
    {{0, 4}, {3, 5}, {2, 6}, {1, 7}},
    {{0, 3}, {2, 4}, {1, 5}, {6, 7}},
    {{0, 2}, {1, 3}, {4, 7}, {5, 6}},
    {{0, 1}, {2, 7}, {3, 6}, {4, 5}},
};

// The rotation of the pair (p, q) from the current A.
__device__ __forceinline__ void angle(float app, float aqq, float apq,
                                      float& c, float& s) {
  const float y = __fmul_rn(2.0f, apq);
  const float x = __fadd_rn(__fsub_rn(app, aqq), TINY);
  const float phi = __fmul_rn(0.5f, atan2f(y, x));
  c = cosf(phi);
  s = sinf(phi);
}

template <int N>
__device__ __forceinline__ void rot_rows(float (&m)[N][N], int p, int q,
                                         float c, float s) {
  const float ns = -s;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float mp = m[p][k], mq = m[q][k];
    m[p][k] = __fadd_rn(__fmul_rn(c, mp), __fmul_rn(s, mq));
    m[q][k] = __fadd_rn(__fmul_rn(ns, mp), __fmul_rn(c, mq));
  }
}

template <int N>
__device__ __forceinline__ void rot_cols(float (&m)[N][N], int p, int q,
                                         float c, float s) {
  const float ns = -s;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float mp = m[k][p], mq = m[k][q];
    m[k][p] = __fadd_rn(__fmul_rn(c, mp), __fmul_rn(s, mq));
    m[k][q] = __fadd_rn(__fmul_rn(ns, mp), __fmul_rn(c, mq));
  }
}

__device__ __forceinline__ void sweeps4(float (&a)[4][4], float (&v)[4][4],
                                        int sweeps) {
#pragma unroll 1
  for (int sweep = 0; sweep < sweeps; ++sweep) {
#pragma unroll
    for (int p = 0; p < 4; ++p) {
#pragma unroll
      for (int q = p + 1; q < 4; ++q) {
        float c, s;
        angle(a[p][p], a[q][q], a[p][q], c, s);
        rot_rows<4>(a, p, q, c, s);
        rot_cols<4>(a, p, q, c, s);
        rot_cols<4>(v, p, q, c, s);
      }
    }
  }
}

// torch.amax / amin over the eigenvalues: a NaN anywhere gives NaN.
__device__ __forceinline__ float max_nan(float m, float x) {
  return (x > m || x != x) ? x : m;
}
__device__ __forceinline__ float min_nan(float m, float x) {
  return (x < m || x != x) ? x : m;
}

// sum_k prod[k] in the order of torch's CUDA reduction (see the top).
template <int N>
__device__ __forceinline__ float tree_sum(const float (&prod)[N]);

template <>
__device__ __forceinline__ float tree_sum<4>(const float (&x)[4]) {
  return __fadd_rn(__fadd_rn(__fadd_rn(0.0f, x[0]), __fadd_rn(0.0f, x[2])),
                   __fadd_rn(__fadd_rn(0.0f, x[1]), __fadd_rn(0.0f, x[3])));
}

template <>
__device__ __forceinline__ float tree_sum<8>(const float (&x)[8]) {
  float r[4];
#pragma unroll
  for (int k = 0; k < 4; ++k)
    r[k] = __fadd_rn(__fadd_rn(0.0f, x[k]), __fadd_rn(0.0f, x[k + 4]));
  return __fadd_rn(__fadd_rn(r[0], r[2]), __fadd_rn(r[1], r[3]));
}

// Step 2 from the eigenvalues w = diag(A): inv_w, in the plain version's
// order of operations.
template <int N>
__device__ __forceinline__ void regularized_inverse(const float (&w)[N],
                                                    float cond_threshold,
                                                    float tikhonov,
                                                    float (&inv_w)[N]) {
  float w_max = w[0], w_min = w[0];
#pragma unroll
  for (int i = 1; i < N; ++i) {
    w_max = max_nan(w_max, w[i]);
    w_min = min_nan(w_min, w[i]);
  }
  const float cond = __fdiv_rn(w_max, __fadd_rn(w_min, 1e-10f));
  const float lam = cond > cond_threshold ? __fmul_rn(tikhonov, w_max)
                                          : 0.0f;
  float top = __fadd_rn(w_max, lam);
  top = top != top ? top : fmaxf(top, 0.0f);
  const float cutoff = __fmul_rn(top, 1e-7f);
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float w2 = __fadd_rn(w[k], lam);
    inv_w[k] = w2 > cutoff ? __fdiv_rn(1.0f, w2) : 0.0f;
  }
}

__global__ void __launch_bounds__(THREADS)
pinv4_kernel(const float* __restrict__ h, float* __restrict__ out, int batch,
             int sweeps, float cond_threshold, float tikhonov) {
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= batch) return;
  const float* src = h + (size_t)b * 16;
  float a[4][4], v[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a[i][j] = src[i * 4 + j];
      v[i][j] = i == j ? 1.0f : 0.0f;
    }
  }
  sweeps4(a, v, sweeps);

  const float w[4] = {a[0][0], a[1][1], a[2][2], a[3][3]};
  float inv_w[4];
  regularized_inverse<4>(w, cond_threshold, tikhonov, inv_w);
  float* dst = out + (size_t)b * 16;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float vs[4];
#pragma unroll
    for (int k = 0; k < 4; ++k) vs[k] = __fmul_rn(v[i][k], inv_w[k]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float prod[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) prod[k] = __fmul_rn(vs[k], v[j][k]);
      dst[i * 4 + j] = tree_sum<4>(prod);
    }
  }
}

// One warp a matrix (see the top): A and V row-major in shared memory.
__global__ void __launch_bounds__(WARPS8 * 32)
pinv8_kernel(const float* __restrict__ h, float* __restrict__ out, int batch,
             int sweeps, float cond_threshold, float tikhonov) {
  __shared__ float a_all[WARPS8][64], v_all[WARPS8][64];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.x * WARPS8 + warp;
  if (b >= batch) return;  // the whole warp
  float* a = a_all[warp];
  float* v = v_all[warp];
  const float* src = h + (size_t)b * 64;
#pragma unroll
  for (int e = lane; e < 64; e += 32) {
    a[e] = src[e];
    v[e] = (e >> 3) == (e & 7) ? 1.0f : 0.0f;
  }
  __syncwarp();

  const int k = lane >> 3, j = lane & 7;
#pragma unroll 1
  for (int sweep = 0; sweep < sweeps; ++sweep) {
#pragma unroll 1
    for (int r = 0; r < 7; ++r) {
      const int p = RR8[r][k][0], q = RR8[r][k][1];
      const float app = a[p * 8 + p], aqq = a[q * 8 + q], apq = a[p * 8 + q];
      // Every lane holds its angle's operands before any row is written.
      __syncwarp();
      float c, s;
      angle(app, aqq, apq, c, s);
      const float ns = -s;
      {  // Rows p and q, column j.
        const float mp = a[p * 8 + j], mq = a[q * 8 + j];
        a[p * 8 + j] = __fadd_rn(__fmul_rn(c, mp), __fmul_rn(s, mq));
        a[q * 8 + j] = __fadd_rn(__fmul_rn(ns, mp), __fmul_rn(c, mq));
      }
      __syncwarp();
      {  // Columns p and q of A, then of V, row j.
        const float mp = a[j * 8 + p], mq = a[j * 8 + q];
        a[j * 8 + p] = __fadd_rn(__fmul_rn(c, mp), __fmul_rn(s, mq));
        a[j * 8 + q] = __fadd_rn(__fmul_rn(ns, mp), __fmul_rn(c, mq));
        const float vp = v[j * 8 + p], vq = v[j * 8 + q];
        v[j * 8 + p] = __fadd_rn(__fmul_rn(c, vp), __fmul_rn(s, vq));
        v[j * 8 + q] = __fadd_rn(__fmul_rn(ns, vp), __fmul_rn(c, vq));
      }
      __syncwarp();
    }
  }

  float w[8], inv_w[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) w[i] = a[i * 8 + i];
  regularized_inverse<8>(w, cond_threshold, tikhonov, inv_w);
  float* dst = out + (size_t)b * 64;
#pragma unroll
  for (int e = lane; e < 64; e += 32) {
    const int i = e >> 3, jj = e & 7;
    float prod[8];
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      prod[kk] = __fmul_rn(__fmul_rn(v[i * 8 + kk], inv_w[kk]),
                           v[jj * 8 + kk]);
    dst[e] = tree_sum<8>(prod);
  }
}

}  // namespace

// sweeps: 6 on every path (the plain version's); chip_smoke.py measures
// the dependent chain with more.
extern "C" int vs_regularized_pinv(const void* h, void* out, int batch, int n,
                                   int sweeps, float cond_threshold,
                                   float tikhonov, void* stream) {
  if (batch < 1 || (n != 4 && n != 8) || sweeps < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* src = (const float*)h;
  float* dst = (float*)out;
  if (n == 4) {
    pinv4_kernel<<<(batch + THREADS - 1) / THREADS, THREADS, 0, st>>>(
        src, dst, batch, sweeps, cond_threshold, tikhonov);
  } else {
    pinv8_kernel<<<(batch + WARPS8 - 1) / WARPS8, WARPS8 * 32, 0, st>>>(
        src, dst, batch, sweeps, cond_threshold, tikhonov);
  }
  return (int)cudaGetLastError();
}
