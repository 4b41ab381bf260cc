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
// 67 TFLOP/s (the roofline bound). What bounds the kernel is latency: the
// dependent steps of one row, each about 10 float operations with one
// IEEE divide on the path. Run in order, a row's pair sweep is iterations
// x (N-1) steps; but pair i of iteration k needs only pair i-1 of
// iteration k and pair i+1 of iteration k-1, so it can run at step
// 2k + i, and a row needs 2 x (iterations - 1) + N - 1 steps (213 at the
// default 100 iterations and N = 16, against 1,500). The design:
//   - N <= LANES (every serving window): the wavefront. One lane owns one
//     column, a warp holds 32 / N rows, blocks of WAVE_THREADS. At step t
//     lane j, with u = t - j, is the left side of pair j of iteration
//     u / 2 if u is even and the right side of pair j - 1 of iteration
//     (u + 1) / 2 if u is odd. The two lanes of a pair swap their values
//     with one __shfl_sync, both run the same pair_update on the same
//     operands, and each keeps its own side; every lane runs the update at
//     every step (on dummy operands where it has no live pair), so the
//     warp never branches. Pairs of one step are 2 apart or more, so no
//     two touch one column. Column j relaxes as the right side just before
//     its pair j - 1 (column 0 as the left side before its pair 0):
//     nothing touches column j between pair j of iteration k - 1 and pair
//     j - 1 of iteration k, so that is the value the in-order loop
//     relaxes. Each value comes from the same operations on the same
//     operands as in the in-order loop: only the lane and the step change.
//   - Larger N: one thread owns one row, in order, the working values in
//     the output row itself (L1 cached), the data read from global memory.
//     Every N runs.
// chip_smoke.py phase D measures one step on the card (one row's device
// time at 1,100 and 100 iterations: the depth differs by 2,000 steps and
// the launch cost drops out) and prints the dependence depth times that
// step beside the kernel's time at each shape.

#include <cuda_runtime.h>
namespace {

constexpr int WAVE_THREADS = 128;
constexpr int LANES = 32;
constexpr int ANY_THREADS = 32;
constexpr unsigned FULL = 0xffffffffu;
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

// N <= LANES: the wavefront (see the top).
__global__ void __launch_bounds__(WAVE_THREADS)
tvl1_wave_kernel(const float* __restrict__ data, const float* __restrict__ lam,
                 const int* __restrict__ valid_len, float* __restrict__ out,
                 int rows, int n, int iterations) {
  const int per_warp = LANES / n;
  const int warp = (blockIdx.x * WAVE_THREADS + threadIdx.x) / LANES;
  if (warp * per_warp >= rows) return;  // the whole warp
  const int lane = threadIdx.x % LANES;
  const int seg = lane / n, j = lane - seg * n;
  const int r = warp * per_warp + seg;
  const bool live = seg < per_warp && r < rows;
  float d = 0.0f, l = 0.0f;
  int v = 0;
  if (live) {
    d = data[(size_t)r * n + j];
    l = lam[r];
    v = valid_len[r];
  }
  float x = d;
  const int last = 2 * (iterations - 1) + (n > 2 ? n - 2 : 0);
  for (int t = 0; t <= last; ++t) {
    const int u = t - j;
    const bool left = (u & 1) == 0;
    const int k = left ? u >> 1 : (u + 1) >> 1;
    const bool now = k >= 0 && k < iterations;
    if (now && (left ? j == 0 : j > 0)) x = relax(x, d);
    const int src = (left ? lane + 1 : lane - 1) & (LANES - 1);
    const float y = __shfl_sync(FULL, x, src);
    // Every lane runs the update, so the warp does not branch and
    // reconverge at every step. A lane without a live pair (no pair this
    // step, its right column at or past valid_len, or a lane past the last
    // row) runs it on 0 and 1, which keep the divide on its fast path (the
    // zeros of an unused lane would not), and keeps its value.
    const int right = left ? j + 1 : j;
    const bool live_pair = now && right > 0 && right < n && right < v;
    float xi = live_pair ? (left ? x : y) : 0.0f;
    float xj = live_pair ? (left ? y : x) : 1.0f;
    pair_update(xi, xj, l, true);
    if (live_pair) x = left ? xi : xj;
  }
  if (live) out[(size_t)r * n + j] = x;
}

// Any N: one thread a row, the working values in the output row.
__global__ void __launch_bounds__(ANY_THREADS)
tvl1_any_kernel(const float* __restrict__ data, const float* __restrict__ lam,
                const int* __restrict__ valid_len, float* __restrict__ out,
                int rows, int n, int iterations) {
  const int r = blockIdx.x * ANY_THREADS + threadIdx.x;
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

}  // namespace

extern "C" int vs_tvl1_smooth(const void* data, const void* lam,
                              const void* valid_len, void* out, int rows,
                              int n, int iterations, void* stream) {
  if (rows < 1 || n < 1 || iterations < 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  const float* d = (const float*)data;
  const float* l = (const float*)lam;
  const int* v = (const int*)valid_len;
  float* o = (float*)out;
  if (n <= LANES) {
    const int per_warp = LANES / n;
    const long long warps = (rows + per_warp - 1) / per_warp;
    const int blocks = (int)((warps * LANES + WAVE_THREADS - 1)
                             / WAVE_THREADS);
    tvl1_wave_kernel<<<blocks, WAVE_THREADS, 0, st>>>(d, l, v, o, rows, n,
                                                      iterations);
  } else {
    tvl1_any_kernel<<<(rows + ANY_THREADS - 1) / ANY_THREADS, ANY_THREADS, 0,
                      st>>>(d, l, v, o, rows, n, iterations);
  }
  return (int)cudaGetLastError();
}
