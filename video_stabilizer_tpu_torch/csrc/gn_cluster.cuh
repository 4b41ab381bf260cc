// What kernels B and C (gn_solve.cu, gn8_solve.cu) share: the cluster-wide
// sum of b in one fixed order, the corner maximum of the stop test, and the
// launch of an item per thread-block cluster.

#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace gn {

namespace cg = cooperative_groups;

constexpr unsigned FULL = 0xffffffffu;

// Largest value of d over the four lanes of each lane group (lane & 3).
__device__ __forceinline__ float corner_max(float d) {
  d = fmaxf(d, __shfl_xor_sync(FULL, d, 2));
  return fmaxf(d, __shfl_xor_sync(FULL, d, 1));
}

// b = the sum over every thread of the cluster of acc, the same bits in
// every thread. Each warp reduces its acc with shuffles and writes it to
// `part`, its CTA's shared-memory buffer of this iteration's parity; one
// barrier (cluster.sync, or __syncthreads for a one-CTA cluster); then
// every warp of every CTA reads all the cluster's cs x WARPS partials
// (through DSMEM) and sums them in one fixed order: lane k * LPK + j takes
// partials m = j, j + LPK, ... (m = rank * WARPS + warp), then a butterfly
// over the LPK lanes of entry k. No atomics, so a launch is deterministic.
// The caller alternates the parity buffer between iterations, so a fast
// CTA cannot overwrite a partial that another is still reading, and ends
// with a cluster.sync so that no CTA leaves while another may read it.
template <int NP, int WARPS>
__device__ __forceinline__ void cluster_sum(cg::cluster_group& cluster,
                                            int cs, float (*part)[NP],
                                            float acc[NP], float b[NP]) {
  constexpr int LPK = 32 / NP;  // lanes summing each entry of b
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
#pragma unroll
  for (int k = 0; k < NP; ++k) {
    float v = acc[k];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
    acc[k] = v;
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < NP; ++k) part[warp][k] = acc[k];
  }
  if (cs > 1) {
    cluster.sync();
  } else {
    __syncthreads();
  }
  const int k_own = lane / LPK;
  float v = 0.0f;
  for (int m = lane % LPK; m < cs * WARPS; m += LPK) {
    const float* src = cs > 1
        ? cluster.map_shared_rank(&part[0][0], m / WARPS)
        : &part[0][0];
    v += src[(m % WARPS) * NP + k_own];
  }
#pragma unroll
  for (int off = LPK / 2; off > 0; off >>= 1)
    v += __shfl_xor_sync(FULL, v, off);
#pragma unroll
  for (int k = 0; k < NP; ++k) b[k] = __shfl_sync(FULL, v, k * LPK);
}

// What one kernel instance's launches have set up: the (cluster, shared
// memory) shapes already checked.
struct LaunchState {
  int shapes[16][2];
  int n_shapes = 0;
};

// Launches `kernel` with `cfg` (whose attribute sets the cluster size
// `cs`). Before the first launch of each (cluster, shared memory) shape it
// raises the kernel's dynamic shared-memory limit where the shape needs
// more (by default a kernel's static and dynamic shared memory together
// stay within 48 KB), and refuses with cudaErrorLaunchOutOfResources a
// shape of which not one cluster can be resident. Returns the CUDA error,
// 0 on success.
template <typename... Params, typename... Args>
int launch_cluster(LaunchState& st, void (*kernel)(Params...),
                   const cudaLaunchConfig_t& cfg, int cs, Args... args) {
  const int smem = (int)cfg.dynamicSmemBytes;
  bool known = false;
  for (int i = 0; i < st.n_shapes; ++i)
    known |= st.shapes[i][0] == cs && st.shapes[i][1] == smem;
  if (!known) {
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return (int)err;
    if (smem > attr.maxDynamicSharedSizeBytes) {
      err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return (int)err;
    }
    int clusters = 0;
    err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
    if (err != cudaSuccess) return (int)err;
    if (clusters < 1) return (int)cudaErrorLaunchOutOfResources;
    if (st.n_shapes < 16) {
      st.shapes[st.n_shapes][0] = cs;
      st.shapes[st.n_shapes][1] = smem;
      ++st.n_shapes;
    }
  }
  cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

// The launch configuration of `batch` items, each a cluster of `cs` CTAs
// of `threads` threads with `smem` bytes of dynamic shared memory. `attr`
// holds the cluster attribute that the configuration points to.
inline cudaLaunchConfig_t cluster_config(cudaLaunchAttribute& attr,
                                         int batch, int cs, int threads,
                                         size_t smem, void* stream) {
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cs;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * cs);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return cfg;
}

}  // namespace gn
