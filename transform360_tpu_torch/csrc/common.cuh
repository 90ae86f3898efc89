// Shared helpers of the transform360_tpu_torch kernels.
//
// Every entry point has a plain C interface (no PyTorch headers), takes
// device pointers and a cudaStream_t as void*, launches on that stream
// (launch), never synchronises, allocates nothing, and returns 0 or the
// launch's cudaError_t.
// A launch made while its stream is being captured returns the kernel node
// it added (captured_node); each kernel's update entry re-points that node
// in the instantiated graph (update_node) with arguments built by the same
// function as the launch's, so a replay runs what an eager launch would.
// The mbarrier, TMA and rounding helpers serve the two ring kernels, K1
// (blur.cu) and K4 (area.cu).

#pragma once

#include <cstdint>
#include <map>
#include <mutex>
#include <utility>
#include <cuda.h>
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

// 16-byte asynchronous copy from device memory to the shared-space
// address s (both 16-aligned).
__device__ __forceinline__ void cp_async16(unsigned s, const void* gmem) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}
// The same to a generic pointer into shared memory.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  cp_async16(static_cast<unsigned>(__cvta_generic_to_shared(smem)), gmem);
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// -- The ring of shared-memory stages of K1 and K4: mbarriers and TMA. --

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}
// Arrives on bar when all of this thread's earlier cp.async copies are done.
__device__ __forceinline__ void mbar_arrive_cp_async(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(smem_u32(bar))
               : "memory");
}
// Waits until the phase of bar with this parity has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@!done bra WAIT;\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}
// One box of a 3-d tensor map (x, y, frame) into shared memory, completing
// on bar (its bytes counted against the barrier's expected transactions).
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int x,
                                         int y, int f) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(x), "r"(y), "r"(f)
      : "memory");
}
// Orders this thread's generic-proxy writes to shared memory before later
// async-proxy (TMA) accesses to it.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// min(max(floor(s + 0.5), 0), maxval) as an integer: s + 0.5 rounded to
// nearest as the plain versions round it, then 2^23 added rounding down,
// which leaves floor(t) in the low bits for 0 <= t < 2^23 (no F2I).
__device__ __forceinline__ uint32_t round_bits(float s, uint32_t maxval) {
  const float t = fmaxf(__fadd_rn(s, 0.5f), 0.0f);
  return min(__float_as_uint(__fadd_rd(t, 8388608.0f)) - 0x4B000000u, maxval);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled (a libcuda entry point), fetched through the
// runtime, so that a library needs no -lcuda; nullptr if it is missing.
inline EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    return e == cudaSuccess && q == cudaDriverEntryPointSuccess ? reinterpret_cast<EncodeTiled>(p)
                                                               : nullptr;
  }();
  return fn;
}

// Lets kernel k take smem bytes of dynamic shared memory (above 48 KB) on
// the current device; sets the attribute only where an earlier call did
// not already allow as much, so that a launch pays for it once.
inline cudaError_t allow_smem(const void* k, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  static std::mutex mu;
  static std::map<std::pair<const void*, int>, int> allowed;  // (kernel, device) -> bytes
  std::lock_guard<std::mutex> lock(mu);
  int& have = allowed[{k, dev}];
  if (smem <= have) return cudaSuccess;
  e = cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == cudaSuccess) have = smem;
  return e;
}

// The kernel node that the launch just made on `stream` added to the
// stream's capture, into *node (nullptr when the stream is not capturing);
// nothing when node is null.  Fails if the capture's one leaf is not a
// kernel node.
inline int captured_node(cudaStream_t stream, void** node) {
  if (node == nullptr) return 0;
  *node = nullptr;
  cudaStreamCaptureStatus status;
  const cudaGraphNode_t* leaves = nullptr;
  size_t n = 0;
#if CUDART_VERSION >= 13000
  cudaError_t e = cudaStreamGetCaptureInfo(stream, &status, nullptr, nullptr, &leaves, nullptr, &n);
#else
  cudaError_t e = cudaStreamGetCaptureInfo(stream, &status, nullptr, nullptr, &leaves, &n);
#endif
  if (e != cudaSuccess) return static_cast<int>(e);
  if (status != cudaStreamCaptureStatusActive) return 0;
  cudaGraphNodeType type;
  if (n != 1 || (e = cudaGraphNodeGetType(leaves[0], &type)) != cudaSuccess ||
      type != cudaGraphNodeTypeKernel)
    return static_cast<int>(e != cudaSuccess ? e : cudaErrorInvalidValue);
  *node = leaves[0];
  return 0;
}

// Launches kernel k on stream, its shared memory allowed first, and
// returns 0 or the launch's error, with the node it added when the stream
// is capturing (captured_node).
inline int launch(const void* k, dim3 grid, dim3 block, int smem, void** args,
                  cudaStream_t stream, void** node) {
  cudaError_t e = allow_smem(k, smem);
  if (e == cudaSuccess) e = cudaLaunchKernel(k, grid, block, args, smem, stream);
  if (e == cudaSuccess) e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  return captured_node(stream, node);
}

// Re-points kernel node `node` of the instantiated graph `exec` to kernel
// k with these arguments: its next launches run them, launches already
// queued keep theirs.
inline int update_node(void* exec, void* node, const void* k, dim3 grid, dim3 block, int smem,
                       void** args) {
  cudaKernelNodeParams p = {};
  p.func = const_cast<void*>(k);
  p.gridDim = grid;
  p.blockDim = block;
  p.sharedMemBytes = static_cast<unsigned>(smem);
  p.kernelParams = args;
  return static_cast<int>(cudaGraphExecKernelNodeSetParams(
      static_cast<cudaGraphExec_t>(exec), static_cast<cudaGraphNode_t>(node), &p));
}

}  // namespace t360

extern "C" const char* t360_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
