// Shared helpers of the transform360_tpu_torch kernels.
//
// Every entry point has a plain C interface (no PyTorch headers), takes
// device pointers and a cudaStream_t as void*, launches on that stream,
// never synchronises, allocates nothing, and returns cudaGetLastError().

#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace t360 {

// OpenCV-style half-up rounding with uint8 saturation: floor(x + 0.5),
// clamped to [0, 255].  (Round-half-to-even would differ on ties.)
__device__ __forceinline__ uint8_t round_u8(float x) {
  float r = floorf(__fadd_rn(x, 0.5f));
  r = fminf(fmaxf(r, 0.0f), 255.0f);
  return static_cast<uint8_t>(r);
}

__device__ __forceinline__ int clamp_idx(int i, int n) {
  return min(max(i, 0), n - 1);
}

// The float value of byte k of w, exactly, with two full-rate instructions
// and not the conversion unit: 0x4B0000bb is the float 2^23 + b.
__device__ __forceinline__ float byte_to_float(uint32_t w, int k) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | k)),
                   8388608.0f);
}

// The float value of 16-bit half k of w, the same way: 0x4B00hhll is the
// float 2^23 + v, exact for every v < 2^16.
__device__ __forceinline__ float half_to_float(uint32_t w, int k) {
  return __fsub_rn(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7410 | (k * 0x22))),
                   8388608.0f);
}

// Sample j of word w as a float: a byte (uint8 planes) or a 16-bit half
// (uint16 planes).
template <typename S>
__device__ __forceinline__ float sample_to_float(uint32_t w, int j) {
  if (sizeof(S) == 1) return byte_to_float(w, j);
  return half_to_float(w, j);
}

// 16-byte asynchronous copy from device to shared memory (both 16-aligned).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

}  // namespace t360

#define T360_CHECK_LAUNCH()                 \
  do {                                      \
    cudaError_t e_ = cudaGetLastError();    \
    if (e_ != cudaSuccess) return (int)e_;  \
  } while (0)

extern "C" const char* t360_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
