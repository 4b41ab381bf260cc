// The stabilizer's accumulator scan: kernel F of the port.
//
// Replaces the lax.scan of the accumulator in the JAX package
// (video_stabilizer_tpu/models/chunked.py:180-201, batch.py:284-331,
// homography_aligner.py:340-377), which XLA runs as one device loop (not a
// Pallas kernel). Eager PyTorch has no device loop, so the plain version
// (ops/accum.py::accum_scan_plain) runs a fold's every expression as its
// own kernel: 142 kernels a step for the similarity model and 232 for the
// homography, 16 steps a chunk. Here a chunk's or a clip's scan is one
// launch.
//
// Contract: B sequences of T steps, P = 4 (similarity [A, B, TX, TY]) or
// P = 8 (homography, H = [[1+p0, p1, p2], [p3, 1+p4, p5], [p6, p7, 1]] on
// width-normalized centred coordinates). Float32, contiguous:
//   meas (B, T, P), smoothed (B, T, P) or null (the smoother off),
//   succ (B, T) and valid (B, T) bytes (valid null: every step valid),
//   accum0 (B, P), decay (B, 5) or null (then the five values of Consts),
//   out (B, T, P): the accumulator after each step, last (B, P).
// Step t of sequence b:
//   1. accum = 0 where succ[t] is false (the current step's failure);
//   2. jitter = compose(meas[t], inverse(smoothed[t])) with the smoother
//      on, else meas[t]; new = compose(accum, jitter): accum first;
//   3. disp = the largest distance a corner (0,0), (w,0), (0,h), (w,h)
//      moves under new;
//   4. f = clamp((disp - min_disp) / (max_disp - min_disp), 0, 1); factor =
//      max_decay if disp > max_disp, min_decay * (1 - f) + max_decay * f if
//      disp > min_disp, else min_decay; new *= factor;
//   5. accum = new where valid[t], else accum as step 1 left it.
// The group algebra is transforms.py / homography.py's, each expression in
// the plain version's order of operations: the similarity's closed-form
// inverse and compose; the homography's adjugate inverse, the 3x3 products
// as (a0*b0 + a1*b1) + a2*b2, and the H22 normalization (every entry
// divided by H22).
//
// Every operation rounds where the plain version's torch kernel does on the
// card (round-to-nearest intrinsics, no FMA whatever the flags; IEEE
// sqrt). The corner constants enter as the float32 values torch's scalar
// operands take (Consts, computed by the wrapper). One division differs in
// kind: torch on the card divides a tensor by a Python float as a multiply
// by the float32 reciprocal, so with the decay given as Python floats the
// quotient of step 4 is (disp - min_disp) * (1 / span) (Consts.inv_span),
// and with a decay row per sequence it is a true division.
// chip_smoke.py phase E holds the kernel to the plain version bit for bit.
//
// Bound on an H100: a chunk is 8 sequences of 16 steps, a few KB; what
// bounds a call is one sequence's chain of T dependent folds (about 60
// float operations each for P = 4 with two divisions and four square
// roots on the path; about 200 for P = 8). The design: one thread owns one
// sequence and runs its T steps in order with the accumulator in
// registers, blocks of 32 threads. chip_smoke.py measures the chain (one
// sequence alone) beside the kernel's time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 32;

// Float32 operands as torch takes them from Python floats (ops/accum.py::
// corner_consts): per corner k, (ca, cb) = (x - cx, y - cy) for P = 4 and
// their width-normalized (u, v) for P = 8, cx0 / cy0 the corner itself.
struct Consts {
  float ca[4], cb[4], cx0[4], cy0[4];
  float w, cx, cy;
  float decay[5];   // min_disp, max_disp, min_decay, max_decay, span
  float inv_span;   // float32 1 / span, for the Python-float decay
};

__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}
__device__ __forceinline__ float div(float a, float b) {
  return __fdiv_rn(a, b);
}

// torch.amax of the four corner distances: a NaN wins.
__device__ __forceinline__ float max_nan(float m, float x) {
  return (x > m || x != x) ? x : m;
}

// --- similarity (transforms.py) ---------------------------------------

__device__ __forceinline__ void sim_inverse(const float (&t)[4],
                                            float (&r)[4]) {
  const float p = add(1.0f, t[0]);
  const float q = t[1];
  const float denom = add(mul(p, p), mul(q, q));
  r[0] = sub(div(p, denom), 1.0f);
  r[1] = div(-q, denom);
  r[2] = div(sub(mul(-p, t[2]), mul(q, t[3])), denom);
  r[3] = div(sub(mul(q, t[2]), mul(p, t[3])), denom);
}

// T2(T1(x)): t1 first.
__device__ __forceinline__ void sim_compose(const float (&t1)[4],
                                            const float (&t2)[4],
                                            float (&r)[4]) {
  const float p1 = add(1.0f, t1[0]), q1 = t1[1];
  const float p2 = add(1.0f, t2[0]), q2 = t2[1];
  r[0] = sub(sub(mul(p2, p1), mul(q2, q1)), 1.0f);
  r[1] = add(mul(p2, q1), mul(q2, p1));
  r[2] = add(sub(mul(p2, t1[2]), mul(q2, t1[3])), t2[2]);
  r[3] = add(add(mul(q2, t1[2]), mul(p2, t1[3])), t2[3]);
}

__device__ __forceinline__ float sim_disp(const float (&t)[4],
                                          const Consts& k) {
  float m = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float pa = add(1.0f, t[0]);
    const float dx = sub(add(add(sub(mul(pa, k.ca[c]), mul(t[1], k.cb[c])),
                                 k.cx),
                             t[2]),
                         k.cx0[c]);
    const float dy = sub(add(add(add(mul(t[1], k.ca[c]), mul(pa, k.cb[c])),
                                 k.cy),
                             t[3]),
                         k.cy0[c]);
    const float d = __fsqrt_rn(add(mul(dx, dx), mul(dy, dy)));
    m = c == 0 ? d : max_nan(m, d);
  }
  return m;
}

// --- homography (homography.py) ----------------------------------------

__device__ __forceinline__ void to_matrix(const float (&p)[8],
                                          float (&m)[3][3]) {
  m[0][0] = add(1.0f, p[0]); m[0][1] = p[1]; m[0][2] = p[2];
  m[1][0] = p[3]; m[1][1] = add(1.0f, p[4]); m[1][2] = p[5];
  m[2][0] = p[6]; m[2][1] = p[7]; m[2][2] = 1.0f;
}

__device__ __forceinline__ void from_matrix(const float (&m)[3][3],
                                            float (&p)[8]) {
  const float d = m[2][2];
  p[0] = sub(div(m[0][0], d), 1.0f);
  p[1] = div(m[0][1], d);
  p[2] = div(m[0][2], d);
  p[3] = div(m[1][0], d);
  p[4] = sub(div(m[1][1], d), 1.0f);
  p[5] = div(m[1][2], d);
  p[6] = div(m[2][0], d);
  p[7] = div(m[2][1], d);
}

__device__ __forceinline__ void matmul3(const float (&a)[3][3],
                                        const float (&b)[3][3],
                                        float (&r)[3][3]) {
#pragma unroll
  for (int i = 0; i < 3; ++i) {
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      r[i][j] = add(add(mul(a[i][0], b[0][j]), mul(a[i][1], b[1][j])),
                    mul(a[i][2], b[2][j]));
    }
  }
}

// H(p2) @ H(p1), H22-normalized: p1 first.
__device__ __forceinline__ void h_compose(const float (&p1)[8],
                                          const float (&p2)[8],
                                          float (&r)[8]) {
  float m1[3][3], m2[3][3], m[3][3];
  to_matrix(p1, m1);
  to_matrix(p2, m2);
  matmul3(m2, m1, m);
  from_matrix(m, r);
}

__device__ __forceinline__ void h_inverse(const float (&p)[8],
                                          float (&r)[8]) {
  float e[3][3], adj[3][3];
  to_matrix(p, e);
  adj[0][0] = sub(mul(e[1][1], e[2][2]), mul(e[1][2], e[2][1]));
  adj[0][1] = sub(mul(e[0][2], e[2][1]), mul(e[0][1], e[2][2]));
  adj[0][2] = sub(mul(e[0][1], e[1][2]), mul(e[0][2], e[1][1]));
  adj[1][0] = sub(mul(e[1][2], e[2][0]), mul(e[1][0], e[2][2]));
  adj[1][1] = sub(mul(e[0][0], e[2][2]), mul(e[0][2], e[2][0]));
  adj[1][2] = sub(mul(e[0][2], e[1][0]), mul(e[0][0], e[1][2]));
  adj[2][0] = sub(mul(e[1][0], e[2][1]), mul(e[1][1], e[2][0]));
  adj[2][1] = sub(mul(e[0][1], e[2][0]), mul(e[0][0], e[2][1]));
  adj[2][2] = sub(mul(e[0][0], e[1][1]), mul(e[0][1], e[1][0]));
  from_matrix(adj, r);
}

__device__ __forceinline__ float h_disp(const float (&p)[8],
                                        const Consts& k) {
  float m = 0.0f;
#pragma unroll
  for (int c = 0; c < 4; ++c) {
    const float u = k.ca[c], v = k.cb[c];
    const float nx = add(add(mul(add(1.0f, p[0]), u), mul(p[1], v)), p[2]);
    const float ny = add(add(mul(p[3], u), mul(add(1.0f, p[4]), v)), p[5]);
    const float den = add(add(mul(p[6], u), mul(p[7], v)), 1.0f);
    const float wx = div(nx, den), wy = div(ny, den);
    const float dx = sub(add(mul(wx, k.w), k.cx), k.cx0[c]);
    const float dy = sub(add(mul(wy, k.w), k.cy), k.cy0[c]);
    const float d = __fsqrt_rn(add(mul(dx, dx), mul(dy, dy)));
    m = c == 0 ? d : max_nan(m, d);
  }
  return m;
}

// --- the scan ----------------------------------------------------------

template <int P>
struct Model;

template <>
struct Model<4> {
  static __device__ __forceinline__ void inverse(const float (&t)[4],
                                                 float (&r)[4]) {
    sim_inverse(t, r);
  }
  static __device__ __forceinline__ void compose(const float (&a)[4],
                                                 const float (&b)[4],
                                                 float (&r)[4]) {
    sim_compose(a, b, r);
  }
  static __device__ __forceinline__ float disp(const float (&t)[4],
                                               const Consts& k) {
    return sim_disp(t, k);
  }
};

template <>
struct Model<8> {
  static __device__ __forceinline__ void inverse(const float (&t)[8],
                                                 float (&r)[8]) {
    h_inverse(t, r);
  }
  static __device__ __forceinline__ void compose(const float (&a)[8],
                                                 const float (&b)[8],
                                                 float (&r)[8]) {
    h_compose(a, b, r);
  }
  static __device__ __forceinline__ float disp(const float (&t)[8],
                                               const Consts& k) {
    return h_disp(t, k);
  }
};

// torch.clamp(x, 0, 1) on the card: NaN stays NaN.
__device__ __forceinline__ float clamp01(float x) {
  return x != x ? x : fminf(fmaxf(x, 0.0f), 1.0f);
}

template <int P>
__global__ void __launch_bounds__(THREADS)
accum_kernel(const float* __restrict__ meas,
             const float* __restrict__ smoothed,
             const uint8_t* __restrict__ succ,
             const uint8_t* __restrict__ valid,
             const float* __restrict__ accum0,
             const float* __restrict__ decay, float* __restrict__ out,
             float* __restrict__ last, int batch, int steps, Consts k) {
  using M = Model<P>;
  const int b = blockIdx.x * THREADS + threadIdx.x;
  if (b >= batch) return;
  float lo_d = k.decay[0], hi_d = k.decay[1], lo_k = k.decay[2],
        hi_k = k.decay[3], span = k.decay[4];
  if (decay != nullptr) {
    const float* d = decay + (size_t)b * 5;
    lo_d = d[0]; hi_d = d[1]; lo_k = d[2]; hi_k = d[3]; span = d[4];
  }
  float acc[P];
#pragma unroll
  for (int i = 0; i < P; ++i) acc[i] = accum0[(size_t)b * P + i];
  for (int t = 0; t < steps; ++t) {
    const size_t row = (size_t)b * steps + t;
    if (!succ[row]) {
#pragma unroll
      for (int i = 0; i < P; ++i) acc[i] = 0.0f;
    }
    if (valid == nullptr || valid[row]) {
      float m[P], jit[P], nw[P];
#pragma unroll
      for (int i = 0; i < P; ++i) m[i] = meas[row * P + i];
      if (smoothed != nullptr) {
        float s[P], inv[P];
#pragma unroll
        for (int i = 0; i < P; ++i) s[i] = smoothed[row * P + i];
        M::inverse(s, inv);
        M::compose(m, inv, jit);
      } else {
#pragma unroll
        for (int i = 0; i < P; ++i) jit[i] = m[i];
      }
      M::compose(acc, jit, nw);
      const float disp = M::disp(nw, k);
      const float num = sub(disp, lo_d);
      const float f = clamp01(decay != nullptr ? div(num, span)
                                               : mul(num, k.inv_span));
      const float factor =
          disp > hi_d ? hi_k
                      : (disp > lo_d ? add(mul(lo_k, sub(1.0f, f)),
                                           mul(hi_k, f))
                                     : lo_k);
#pragma unroll
      for (int i = 0; i < P; ++i) acc[i] = mul(nw[i], factor);
    }
#pragma unroll
    for (int i = 0; i < P; ++i) out[row * P + i] = acc[i];
  }
#pragma unroll
  for (int i = 0; i < P; ++i) last[(size_t)b * P + i] = acc[i];
}

}  // namespace

// consts: 25 host floats, Consts' fields in order.
extern "C" int vs_accum_scan(const void* meas, const void* smoothed,
                             const void* succ, const void* valid,
                             const void* accum0, const void* decay, void* out,
                             void* last, int batch, int steps, int p,
                             const float* consts, void* stream) {
  if (batch < 1 || steps < 1 || (p != 4 && p != 8) || consts == nullptr)
    return (int)cudaErrorInvalidValue;
  static_assert(sizeof(Consts) == 25 * sizeof(float), "Consts layout");
  Consts k;
  float* dst = reinterpret_cast<float*>(&k);
  for (int i = 0; i < 25; ++i) dst[i] = consts[i];
  const int blocks = (batch + THREADS - 1) / THREADS;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* m = (const float*)meas;
  const float* s = (const float*)smoothed;
  const uint8_t* ok = (const uint8_t*)succ;
  const uint8_t* v = (const uint8_t*)valid;
  const float* a0 = (const float*)accum0;
  const float* d = (const float*)decay;
  float* o = (float*)out;
  float* l = (float*)last;
  if (p == 4) {
    accum_kernel<4><<<blocks, THREADS, 0, st>>>(m, s, ok, v, a0, d, o, l,
                                                batch, steps, k);
  } else {
    accum_kernel<8><<<blocks, THREADS, 0, st>>>(m, s, ok, v, a0, d, o, l,
                                                batch, steps, k);
  }
  return (int)cudaGetLastError();
}
