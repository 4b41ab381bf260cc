// The TV-L1 trajectory smoother's whole device loop: kernel D of the port.
//
// Replaces video_stabilizer_tpu/models/smoother.py::tvl1_smooth, a
// lax.scan of `iterations` steps that XLA fuses into a handful of kernels
// inside one device loop (not a Pallas kernel). Eager PyTorch has no device
// loop, so the plain version (ops/tvl1.py::tvl1_smooth_plain) issues one
// kernel per expression: 100 x 15 pair updates of about 20 kernels each
// at the default window of 16. Here the whole loop is one launch.
//
// Contract: R rows of length N, float32 (R, N) contiguous; one float32 lam
// and one int32 valid_len per row. Each iteration:
//   1. every column relaxes toward the data: x = 0.5*x + 0.5*d;
//   2. pairs i = 0 .. N-2 update in order (Gauss-Seidel): diff = x[i+1] -
//      x[i], mag = |diff|, shrink = ((mag - lam) / max(mag, FLT_MIN)) *
//      0.5, mid = 0.5 * (x[i] + x[i+1]); if mag > lam both move by
//      diff*shrink toward each other, else both become mid. A pair with
//      i + 1 >= valid_len leaves both values as they were.
// Output: all N columns, (R, N) float32.
//
// Every operation rounds where the plain version's torch kernel does: the
// adds, multiplies and the divide are written as round-to-nearest
// intrinsics (__fadd_rn, __fmul_rn, __fdiv_rn: IEEE division), so nothing
// is contracted into an FMA whatever the flags; max(mag, FLT_MIN)
// propagates NaN, as torch.clamp and jnp.maximum do (fmaxf would not). So
// the kernel is bit-equal to the plain version on the card, NaN rows
// included.
//
// Bound on an H100. Bytes and operations are tiny: at the 1080p chunk's
// 512 rows of 16, 66 KB and about 12 MFLOP, under 1 us over 3.35 TB/s and
// 67 TFLOP/s (the roofline bound). What bounds the kernel is latency: one
// row's pair sweep is a chain of iterations x (N-1) dependent steps, each
// about 10 float operations with one IEEE divide on the path. chip_smoke.py
// phase D measures that chain on the card (one row's device time at 11 x
// and 1 x the iterations, the difference over 10: the launch cost drops
// out) and prints it beside the kernel's time at each shape (the
// dependent-chain figure). The design:
//   - One thread owns one row, blocks of 32 threads, so rows spread over
//     as many SMs as there are warps; nothing is shared between threads.
//   - N <= REG_MAX: the row's N data and N working values live in
//     registers (one template instance per N, the pair loop unrolled).
//   - Larger N: the working values live in the output row itself (L1
//     cached), the data is read from global memory. Every N runs.
// The true dependence graph is shallower than the chain the thread runs:
// pair i of iteration k needs pair i-1 of iteration k and pair i+1 of
// iteration k-1, a wavefront of about 2 x iterations + N steps. Overlapping
// iterations (or splitting a row across lanes) is later work.

#include <cuda_runtime.h>
#include <stdint.h>

#include <utility>

namespace {

constexpr int THREADS = 32;
constexpr int REG_MAX = 32;
constexpr float TINY = 1.17549435e-38f;  // FLT_MIN, finfo(float32).tiny

__device__ __forceinline__ float relax(float x, float d) {
  return __fadd_rn(__fmul_rn(0.5f, x), __fmul_rn(0.5f, d));
}

// One pair update, in the plain version's order of rounding.
__device__ __forceinline__ void pair_update(float& xi, float& xj, float lam,
                                            bool active) {
  const float diff = __fsub_rn(xj, xi);
  const float mag = fabsf(diff);
  const float m = mag < TINY ? TINY : mag;  // NaN stays NaN
  const float shrink = __fmul_rn(__fdiv_rn(__fsub_rn(mag, lam), m), 0.5f);
  const float mid = __fmul_rn(0.5f, __fadd_rn(xi, xj));
  const bool take = mag > lam;
  const float step = __fmul_rn(diff, shrink);
  const float new_i = take ? __fadd_rn(xi, step) : mid;
  const float new_j = take ? __fsub_rn(xj, step) : mid;
  if (active) {
    xi = new_i;
    xj = new_j;
  }
}

template <int N>
__global__ void __launch_bounds__(THREADS)
tvl1_reg_kernel(const float* __restrict__ data, const float* __restrict__ lam,
                const int* __restrict__ valid_len, float* __restrict__ out,
                int rows, int iterations) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= rows) return;
  const float* src = data + (size_t)r * N;
  float d[N], x[N];
#pragma unroll
  for (int i = 0; i < N; ++i) {
    d[i] = src[i];
    x[i] = d[i];
  }
  const float l = lam[r];
  const int v = valid_len[r];
  for (int it = 0; it < iterations; ++it) {
#pragma unroll
    for (int i = 0; i < N; ++i) x[i] = relax(x[i], d[i]);
#pragma unroll
    for (int i = 0; i + 1 < N; ++i) pair_update(x[i], x[i + 1], l, i + 1 < v);
  }
  float* dst = out + (size_t)r * N;
#pragma unroll
  for (int i = 0; i < N; ++i) dst[i] = x[i];
}

// Any N: the working values in the output row.
__global__ void __launch_bounds__(THREADS)
tvl1_any_kernel(const float* __restrict__ data, const float* __restrict__ lam,
                const int* __restrict__ valid_len, float* __restrict__ out,
                int rows, int n, int iterations) {
  const int r = blockIdx.x * THREADS + threadIdx.x;
  if (r >= rows) return;
  const float* d = data + (size_t)r * n;
  float* x = out + (size_t)r * n;
  for (int i = 0; i < n; ++i) x[i] = d[i];
  const float l = lam[r];
  const int v = valid_len[r];
  for (int it = 0; it < iterations; ++it) {
    // Column i + 1 relaxes just before pair i, the first pair to read it:
    // the same values as relaxing every column first.
    float xi = relax(x[0], d[0]);
    for (int i = 0; i + 1 < n; ++i) {
      float xj = relax(x[i + 1], d[i + 1]);
      pair_update(xi, xj, l, i + 1 < v);
      x[i] = xi;
      xi = xj;
    }
    x[n - 1] = xi;
  }
}

template <int N>
void launch_reg(int blocks, cudaStream_t st, const float* data,
                const float* lam, const int* valid_len, float* out, int rows,
                int iterations) {
  tvl1_reg_kernel<N><<<blocks, THREADS, 0, st>>>(data, lam, valid_len, out,
                                                 rows, iterations);
}

template <int... Ns>
bool dispatch_reg(int n, int blocks, cudaStream_t st, const float* data,
                  const float* lam, const int* valid_len, float* out,
                  int rows, int iterations) {
  return ((n == Ns ? (launch_reg<Ns>(blocks, st, data, lam, valid_len, out,
                                     rows, iterations),
                      true)
                   : false) || ...);
}

template <int... Ns>
bool dispatch_seq(int n, int blocks, cudaStream_t st, const float* data,
                  const float* lam, const int* valid_len, float* out,
                  int rows, int iterations,
                  std::integer_sequence<int, Ns...>) {
  return dispatch_reg<(Ns + 1)...>(n, blocks, st, data, lam, valid_len, out,
                                   rows, iterations);
}

}  // namespace

extern "C" int vs_tvl1_smooth(const void* data, const void* lam,
                              const void* valid_len, void* out, int rows,
                              int n, int iterations, void* stream) {
  if (rows < 1 || n < 1 || iterations < 0)
    return (int)cudaErrorInvalidValue;
  const int blocks = (rows + THREADS - 1) / THREADS;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* d = (const float*)data;
  const float* l = (const float*)lam;
  const int* v = (const int*)valid_len;
  float* o = (float*)out;
  if (n <= REG_MAX) {
    dispatch_seq(n, blocks, st, d, l, v, o, rows, iterations,
                 std::make_integer_sequence<int, REG_MAX>{});
  } else {
    tvl1_any_kernel<<<blocks, THREADS, 0, st>>>(d, l, v, o, rows, n,
                                               iterations);
  }
  return (int)cudaGetLastError();
}
