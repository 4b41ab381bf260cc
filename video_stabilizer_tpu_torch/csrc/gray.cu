// BGR to gray: kernel G of the port.
//
// Replaces video_stabilizer_tpu/models/stabilizer.py::bgr_to_gray, which
// XLA fuses into one pass over the frames (not a Pallas kernel). Eager
// PyTorch runs its plain version (ops/gray.py::bgr_to_gray_plain) as about
// ten kernels: three strided u8 -> float32 casts, three multiplies, two
// adds, the round and the cast, four of them writing float32 tensors of the
// frames' size. Here the conversion is one launch.
//
// Contract: P pixels of 3 bytes (B, G, R), contiguous; P gray bytes out.
// Per pixel: rint((0.114f * b + 0.587f * g) + 0.299f * r), each product and
// each sum rounded to float32 (round-to-nearest intrinsics: no FMA
// whatever the flags), the round half to even (as torch.round and
// jnp.round), the constants the float32 roundings of the Python floats
// (as torch takes a Python scalar operand). So the kernel is bit-equal to
// the plain version on the card; chip_smoke.py phase G checks all 2^24
// BGR triples.
//
// Bound on an H100: 4 bytes a pixel (3 read, 1 written) and about 10
// operations, so bytes: the 1080p chunk's 8 x 16 frames (265.4 Mpx) are
// 1.062 GB, 0.317 ms at 3.35 TB/s. The design: one thread converts 16
// pixels, reading its 48 bytes as three 16-byte loads and writing its 16
// gray bytes as one, where both pointers are 16-byte aligned; the ragged
// tail (and an unaligned call) goes a byte at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int PIXELS = 16;  // per thread

__device__ __forceinline__ uint32_t gray1(uint32_t b, uint32_t g,
                                          uint32_t r) {
  const float kb = static_cast<float>(0.114);
  const float kg = static_cast<float>(0.587);
  const float kr = static_cast<float>(0.299);
  const float v = __fadd_rn(__fadd_rn(__fmul_rn(kb, (float)b),
                                      __fmul_rn(kg, (float)g)),
                            __fmul_rn(kr, (float)r));
  return __float2uint_rn(v);  // half to even; v is in [0, 255.5)
}

__device__ __forceinline__ uint32_t byte_of(const uint32_t* w, int k) {
  return (w[k >> 2] >> (8 * (k & 3))) & 0xffu;
}

__global__ void __launch_bounds__(THREADS)
    gray_kernel(const uint8_t* __restrict__ bgr, uint8_t* __restrict__ gray,
                long long pixels, int aligned) {
  const long long p0 =
      ((long long)blockIdx.x * THREADS + threadIdx.x) * PIXELS;
  if (p0 >= pixels) return;
  if (aligned && p0 + PIXELS <= pixels) {
    const uint4* src = reinterpret_cast<const uint4*>(bgr + 3 * p0);
    const uint4 a = src[0], b = src[1], c = src[2];
    const uint32_t w[12] = {a.x, a.y, a.z, a.w, b.x, b.y,
                            b.z, b.w, c.x, c.y, c.z, c.w};
    uint32_t o[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      uint32_t word = 0;
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int px = 3 * (4 * q + k);
        word |= gray1(byte_of(w, px), byte_of(w, px + 1), byte_of(w, px + 2))
                << (8 * k);
      }
      o[q] = word;
    }
    *reinterpret_cast<uint4*>(gray + p0) = make_uint4(o[0], o[1], o[2], o[3]);
    return;
  }
  for (int k = 0; k < PIXELS; ++k) {
    const long long p = p0 + k;
    if (p >= pixels) break;
    gray[p] = (uint8_t)gray1(bgr[3 * p], bgr[3 * p + 1], bgr[3 * p + 2]);
  }
}

}  // namespace

extern "C" int vs_bgr_to_gray(const void* bgr, void* gray, long long pixels,
                              void* stream) {
  if (pixels < 1) return (int)cudaErrorInvalidValue;
  const int aligned =
      (uintptr_t)bgr % 16 == 0 && (uintptr_t)gray % 16 == 0;
  const long long threads = (pixels + PIXELS - 1) / PIXELS;
  const long long blocks = (threads + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gray_kernel<<<(unsigned)blocks, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)bgr, (uint8_t*)gray, pixels, aligned);
  return (int)cudaGetLastError();
}
