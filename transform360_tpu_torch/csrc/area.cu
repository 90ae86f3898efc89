// K4: the INTER_AREA resize of a supersampled plane with its half-up
// round, in one pass, for uint8 planes and for uint16 planes (the 10-,
// 12- and 16-bit formats).
//
// Replaces the XLA stage of the JAX package's supersampling epilogue:
// transform360_tpu/sampling.py:483 (apply_area_resize, two dense einsums),
// fused with its round inside the jitted plane program at
// transform360_tpu/pipeline.py:304-311.  It is no Pallas kernel there.  It
// computes the function of the plain version
// transform360_tpu_torch.ops.area.area_plain -- round_px(area_resize(...))
// -- bit for bit: per output pixel (r, c) and for ascending column tap kc,
// the row pass h = sum over ascending kr of float(x[ri[r,kr], ci[c,kc]]) *
// rw[r,kr] (the kr = 0 product itself, then each product added), times
// cw[c,kc], summed in ascending kc; every product and every sum is rounded
// on its own (-fmad=false, __fmul_rn/__fadd_rn), then floor(s + 0.5) is
// clamped to [0, maxval].  Tap indices are first + k clamped into the
// input, as AreaAxis.indices gives them; the zero-weight padding taps add
// +0 to a sum of non-negative terms, which changes no bit, so they run.
//
// What bounds it on the H100: bytes.  At the 2x2 flagship a 3072x2048
// luma frame (6.3 MB) becomes 1536x1024 (1.6 MB) with about 9 float
// operations per output pixel against at least 5 bytes moved.  The plain
// version writes a float32 tensor of the whole scaled plane per op; K4
// reads each sample once and writes each output once.  Each CTA of 256
// threads takes one 8x128 output tile of the plan (ops/area.py, built once
// per plan and device), one warp per output row and the columns lane,
// lane + 32, lane + 64, lane + 96 per thread, so that neighbouring lanes
// read neighbouring staged samples (no bank conflict) and store
// neighbouring outputs.  Once per CTA each thread loads its row's and its
// columns' tap offsets and weights into registers (2 or 4 taps per axis, a
// template parameter: the first build kept them in shared memory and lost
// most of its time to bank conflicts on them); then, for each frame of its
// group (blockIdx.y), the CTA stages the input rows and columns that the
// tile's taps span (16 x 256 samples at 2x2) with 16-byte cp.async where
// the plane's rows are 16-byte aligned, double-buffered so that the next
// frame loads while this one is summed (a ring of 3 or 4 buffers measured
// no faster).  Samples become
// floats by an OR into 0x4B000000 and one subtract (no I2F).  Tiles of a
// plan with more than 4 taps on an axis, or whose span exceeds the plan's
// shared-memory budget (large factors such as 8x), have pitch 0 and read
// device memory directly in this same kernel.

#include "common.cuh"

namespace {

constexpr int kTR = 8, kTC = 128;  // output tile rows, columns
constexpr int kThreads = 256;  // a warp per output row, columns lane + 32 j
static_assert(kThreads == 32 * kTR && kTC == 4 * 32, "a warp per row, 4 columns per lane");

struct Args {
  const void* src;        // [B, H, W]
  void* dst;              // [B, OH, OW]
  const int* tiles;       // [n, 8]: r0, c0, rows, cols, y0, x0, span rows, pitch (0: direct)
  const int* row_first;   // [OH]
  const float* row_w;     // [OH, kr]
  const int* col_first;   // [OW]
  const float* col_w;     // [OW, kc]
  int B, H, W, OH, OW, kr, kc;
  int frames;             // frames per CTA
  int stage_bytes;        // one staged buffer
  float maxval;
  bool vec;               // rows and src 16-byte aligned: cp.async chunks
};

// The exact float value of a sample (< 2^23): 0x4B000000 | v is 2^23 + v.
__device__ __forceinline__ float sample_float(uint32_t v) {
  return __fsub_rn(__uint_as_float(0x4B000000u | v), 8388608.0f);
}

template <typename S>
__device__ __forceinline__ S round_sample(float s, float maxval) {
  float r = floorf(__fadd_rn(s, 0.5f));
  r = fminf(fmaxf(r, 0.0f), maxval);
  return static_cast<S>(static_cast<uint32_t>(r));
}

// Stage frame `src` (already offset to the tile's first row and column)
// into buf: span rows of `pitch` samples; columns at or past the plane's
// width are not loaded (no tap reads them).  The caller commits.
template <typename S>
__device__ __forceinline__ void stage(S* buf, const S* src, int span, int pitch, int cols,
                                      int W, bool vec) {
  if (vec) {
    constexpr int kChunk = 16 / sizeof(S);
    const int per_row = pitch / kChunk;
    const int inside = cols / kChunk;  // cols and W are whole chunks here
    for (int i = threadIdx.x; i < span * per_row; i += kThreads) {
      const int row = i / per_row, ch = i - row * per_row;
      if (ch < inside)
        t360::cp_async16(buf + row * pitch + ch * kChunk,
                         src + static_cast<size_t>(row) * W + ch * kChunk);
    }
  } else {
    for (int i = threadIdx.x; i < span * pitch; i += kThreads) {
      const int row = i / pitch, col = i - row * pitch;
      if (col < cols) buf[i] = src[static_cast<size_t>(row) * W + col];
    }
  }
}

// One output pixel from device memory, with any number of taps.
template <typename S>
__device__ __forceinline__ float sum_global(const S* src, const Args& a, int r, int c) {
  float s = 0.0f;
  for (int q = 0; q < a.kc; ++q) {
    const S* col = src + min(__ldg(a.col_first + c) + q, a.W - 1);
    float h = 0.0f;
    for (int p = 0; p < a.kr; ++p) {
      const int y = min(__ldg(a.row_first + r) + p, a.H - 1);
      const float term = __fmul_rn(sample_float(col[static_cast<size_t>(y) * a.W]),
                                   __ldg(a.row_w + r * a.kr + p));
      h = p == 0 ? term : __fadd_rn(h, term);
    }
    const float term = __fmul_rn(h, __ldg(a.col_w + c * a.kc + q));
    s = q == 0 ? term : __fadd_rn(s, term);
  }
  return s;
}

// K: the taps held in registers per axis on the staged path (the plan's
// kr and kc, padded with zero weights on the last real tap: each adds +0
// to a sum of non-negative terms, which changes no bit).
template <typename S, int K>
__global__ void __launch_bounds__(kThreads) area_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int* t = a.tiles + blockIdx.x * 8;
  const int r0 = t[0], c0 = t[1], nr = t[2], nc = t[3];
  const int y0 = t[4], x0 = t[5], span = t[6], pitch = t[7];
  const int f0 = blockIdx.y * a.frames;
  const int nf = min(a.frames, a.B - f0);
  const int tr = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const bool row_in = tr < nr;
  const int r = r0 + min(tr, nr - 1);
  const size_t plane = static_cast<size_t>(a.H) * a.W;
  const size_t oplane = static_cast<size_t>(a.OH) * a.OW;
  const S* src = static_cast<const S*>(a.src) + f0 * plane;
  S* dst = static_cast<S*>(a.dst) + f0 * oplane + static_cast<size_t>(r) * a.OW + c0 + lane;

  if (pitch == 0) {  // direct: taps read from device memory
    if (!row_in) return;
    for (int f = 0; f < nf; ++f, src += plane, dst += oplane)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        if (lane + 32 * j < nc)
          dst[32 * j] = round_sample<S>(sum_global<S>(src, a, r, c0 + lane + 32 * j), a.maxval);
    return;
  }

  // this thread's taps: its row's, and its 4 columns' (lane + 32 j), as
  // offsets in the staged span
  int roff[K], coff[4][K];
  float rw[K], cw[4][K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int p = min(k, a.kr - 1);
    roff[k] = (min(__ldg(a.row_first + r) + p, a.H - 1) - y0) * pitch;
    rw[k] = k < a.kr ? __ldg(a.row_w + r * a.kr + p) : 0.0f;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int c = c0 + min(lane + 32 * j, nc - 1);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int q = min(k, a.kc - 1);
      coff[j][k] = min(__ldg(a.col_first + c) + q, a.W - 1) - x0;
      cw[j][k] = k < a.kc ? __ldg(a.col_w + c * a.kc + q) : 0.0f;
    }
  }

  const int cols = min(pitch, a.W - x0);
  const S* tile_src = src + static_cast<size_t>(y0) * a.W + x0;
  S* const buf0 = reinterpret_cast<S*>(smem);
  S* const buf1 = reinterpret_cast<S*>(smem + a.stage_bytes);
  stage<S>(buf0, tile_src, span, pitch, cols, a.W, a.vec);
  t360::cp_async_commit();
  for (int f = 0; f < nf; ++f, dst += oplane) {
    if (f + 1 < nf) {
      stage<S>((f & 1) ? buf0 : buf1, tile_src + (f + 1) * plane, span, pitch, cols, a.W, a.vec);
      t360::cp_async_commit();
      t360::cp_async_wait<1>();
    } else {
      t360::cp_async_wait<0>();
    }
    __syncthreads();  // this frame's span is complete
    const S* buf = (f & 1) ? buf1 : buf0;
    if (row_in) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float s = 0.0f;
#pragma unroll
        for (int q = 0; q < K; ++q) {
          const S* col = buf + coff[j][q];
          float h = 0.0f;
#pragma unroll
          for (int p = 0; p < K; ++p) {
            const float term = __fmul_rn(sample_float(col[roff[p]]), rw[p]);
            h = p == 0 ? term : __fadd_rn(h, term);
          }
          const float term = __fmul_rn(h, cw[j][q]);
          s = q == 0 ? term : __fadd_rn(s, term);
        }
        if (lane + 32 * j < nc) dst[32 * j] = round_sample<S>(s, a.maxval);
      }
    }
    __syncthreads();  // this buffer is free for the frame after next
  }
}

template <typename S>
const void* with_taps(int taps) {
  switch (taps) {
    case 2: return reinterpret_cast<const void*>(area_kernel<S, 2>);
    case 4: return reinterpret_cast<const void*>(area_kernel<S, 4>);
    default: return nullptr;
  }
}

// The instantiation for a sample size (1: uint8, 2: uint16) and 2 or 4
// register taps per axis.
const void* kernel_for(int sample_bytes, int taps) {
  switch (sample_bytes) {
    case 1: return with_taps<uint8_t>(taps);
    case 2: return with_taps<uint16_t>(taps);
    default: return nullptr;
  }
}

cudaError_t allow_smem(const void* k, int smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(k, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
}

}  // namespace

// src: [B, H, W] and dst: [B, OH, OW] samples of sample_bytes each (1:
// uint8; 2: uint16, rounded and saturated to maxval, the depth's largest
// sample); row_first int32 [OH], row_w float32 [OH, kr]; col_first int32
// [OW], col_w float32 [OW, kc]; tiles int32 [n, 8] (r0, c0, rows, cols,
// y0, x0, span rows, pitch in samples, a multiple of 16; pitch 0: direct).
// taps: 2 or 4, at least kr and kc if any tile is staged.  stage_bytes:
// one staged buffer (the largest span x pitch x sample_bytes over the
// staged tiles, a multiple of 16), 0 if no tile is staged; a CTA holds
// two.  Each CTA takes `frames` consecutive frames.
// vec: W * sample_bytes and src 16-byte aligned.
extern "C" int t360_area(const void* src, void* dst, int sample_bytes, float maxval, int B,
                         int H, int W, int OH, int OW, const int* row_first, const float* row_w,
                         int kr, const int* col_first, const float* col_w, int kc, int taps,
                         const int* tiles, int n_tiles, int stage_bytes, int frames, int vec,
                         void* stream) {
  const void* k = kernel_for(sample_bytes, taps);
  const int smem = 2 * stage_bytes;
  if (k == nullptr || B <= 0 || H <= 0 || W <= 0 || OH <= 0 || OW <= 0 || kr <= 0 ||
      kc <= 0 || (stage_bytes > 0 && (kr > taps || kc > taps)) || n_tiles <= 0 ||
      stage_bytes < 0 || (stage_bytes & 15) != 0 || frames <= 0 ||
      (B + frames - 1) / frames > 65535 || smem > 227 * 1024 ||
      (sample_bytes == 1 ? maxval != 255.0f : !(maxval >= 255.0f && maxval <= 65535.0f)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = allow_smem(k, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  Args a{src, dst, tiles, row_first, row_w, col_first, col_w, B, H, W, OH, OW, kr, kc,
         frames, stage_bytes, maxval, vec != 0};
  void* args[] = {&a};
  const dim3 grid(n_tiles, (B + frames - 1) / frames);
  e = cudaLaunchKernel(k, grid, dim3(kThreads), args, smem, static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return static_cast<int>(e);
  T360_CHECK_LAUNCH();
  return 0;
}

// One instantiation's registers, local memory bytes (spills and stack),
// resident CTAs per SM and dynamic shared memory for a launch with two
// staged buffers of stage_bytes: out[0..3].
extern "C" int t360_area_attrs(int sample_bytes, int taps, int stage_bytes, int* out) {
  const void* k = kernel_for(sample_bytes, taps);
  if (k == nullptr || stage_bytes < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, k);
  const int smem = 2 * stage_bytes;
  if (e == cudaSuccess) e = allow_smem(k, smem);
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, kThreads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = blocks;
  out[3] = smem;
  return 0;
}
