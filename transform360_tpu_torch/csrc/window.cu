// K3: the uint8 remap on OpenCV's 1/32 grid, staged through shared memory
// one output tile at a time, with the half-up round, at every batch size.
//
// Replaces the Pallas kernel transform360_tpu/ops/remap_pallas.py:441
// (_make_kernel, run by _run_class, entry remap_pallas) together with its
// XLA gather for oversized subtiles (_run_fallback, remap_pallas.py:639),
// its padded plane (pad_plane, :364) and the BORDER_TRANSPARENT fix-up the
// JAX pipeline applies after it (sampling.fixup_values).  It also computes
// the function of the lane-batched kernels B2-B4 (remap_lane.py), and of
// the plain version transform360_tpu_torch.sampling.remap_plain, bit for
// bit.
//
// What bounds it on the H100: latency and instructions, not bytes.  A 4K
// luma frame is 8.3 MB in and 1.6 MB out, but every output pixel gathers
// T x T taps from anywhere in a window of the source.  K3 gives each CTA
// one output tile of TH x TW pixels (ops/window.py builds the plan on the
// CPU): the CTA copies the tile's source window -- wh rows of `pitch`
// bytes from a 16-aligned column -- into shared memory with 16-byte
// cp.async loads, frame by frame, double-buffered so that frame f+1's
// window loads while frame f is computed (the counterpart of the TPU
// kernel's double-buffered window DMA), and reads its plan once for all
// the frames of the batch.  Border rules are resolved while
// loading (wrap modulo the plane, clamp, or REFLECT_101), so no padded
// copy of the plane exists; chunks that straddle the seam or an edge, or
// planes whose width is not a multiple of 16, are loaded byte by byte.
// Tiles whose window exceeds the largest class (cubemap pole tiles) have
// pitch 0 and gather from device memory in this same kernel.
//
// Per pixel the plan holds ly | lx << 16 (window-relative first tap),
// fy (bit 7: outside the valid mask) and fx: 6 B.  Tap weights are
// float32(w1[fy][ty] * w1[fx][tx]) from the float64 table w1 [32, T] in
// shared memory -- the very values of sampling.weight_table -- and the
// sum runs ty-major, tx-minor, each product and each sum rounded on its
// own (-fmad=false; __fmul_rn/__fadd_rn), the fill term last.

#include "common.cuh"

namespace {

constexpr int kTH = 16;
constexpr int kTW = 16;
constexpr int kThreads = kTH * kTW;  // one output pixel per thread
constexpr int kTab = 32;             // INTER_TAB_SIZE
constexpr int kTableBytes = kTab * 8 * 8;  // float64 [32, T <= 8]

template <int MODE>
__device__ __forceinline__ int resolve(int i, int n) {
  if (MODE == 0) {  // wrap
    int r = i % n;
    return r < 0 ? r + n : r;
  }
  if (MODE == 2) {  // BORDER_REFLECT_101, closed form (period 2n-2)
    if (n == 1) return 0;
    const int period = 2 * n - 2;
    const int r = abs(i) % period;
    return r >= n ? period - r : r;
  }
  return t360::clamp_idx(i, n);  // fill: clamp, weight zeroed below
}

// Copy one frame's window (wh rows of `pitch` bytes from (y0, x0)) into
// `buf`, resolving the border rule per row and per chunk.
template <int MODE>
__device__ __forceinline__ void stage(const uint8_t* __restrict__ frame,
                                      uint8_t* buf, int y0, int x0, int wh,
                                      int pitch, int H, int W, bool vec) {
  const int cpr = pitch >> 4;
  const int n = wh * cpr;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / cpr;
    const int gx = x0 + ((i - r * cpr) << 4);
    const uint8_t* row = frame + static_cast<size_t>(resolve<MODE>(y0 + r, H)) * W;
    uint8_t* d = buf + r * pitch + (gx - x0);
    // past the seam a wrapped window continues at column gx - W
    const int gv = (MODE == 0 && gx >= W) ? gx - W : gx;
    if (vec && gv >= 0 && gv + 16 <= W) {
      t360::cp_async16(d, row + gv);
    } else {
#pragma unroll
      for (int j = 0; j < 16; ++j) d[j] = row[resolve<MODE>(gx + j, W)];
    }
  }
}

template <int T, int MODE>
__global__ void __launch_bounds__(kThreads)
    window_kernel(const uint8_t* __restrict__ src, uint8_t* __restrict__ dst,
                  int B, int H, int W, int out_h, int out_w,
                  const int* __restrict__ meta, const uint32_t* __restrict__ pos,
                  const uint8_t* __restrict__ fyv, const uint8_t* __restrict__ fxv,
                  const double* __restrict__ w1, int first, int win_bytes,
                  float fill, bool vec) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* s_w = reinterpret_cast<double*>(smem);
  uint8_t* bufs = smem + kTableBytes;

  const int t = first + blockIdx.x;
  const int* m = meta + 6 * t;
  const int oy = m[0] + threadIdx.x / kTW;
  const int ox = m[1] + threadIdx.x % kTW;
  const int y0 = m[2], x0 = m[3], wh = m[4], pitch = m[5];
  const bool staged = pitch > 0;  // uniform over the CTA
  const size_t plane = static_cast<size_t>(H) * W;
  const int N = out_h * out_w;

  if (staged) {  // frame 0's window is in flight while the plan is read
    stage<MODE>(src, bufs, y0, x0, wh, pitch, H, W, vec);
    t360::cp_async_commit();
  }
  for (int i = threadIdx.x; i < kTab * T; i += kThreads) s_w[i] = w1[i];

  const size_t px = static_cast<size_t>(t) * kThreads + threadIdx.x;
  const uint32_t p = pos[px];
  const int ly = static_cast<int>(p & 0xFFFFu);
  const int lx = static_cast<int>(p >> 16);
  const int fyb = fyv[px];
  const int fy = fyb & 0x7F;
  const int fx = fxv[px];
  const bool active = oy < out_h && ox < out_w;
  const bool invalid = (fyb & 0x80) != 0;
  __syncthreads();  // the weight table

  float w[T * T];
  float fill_w = 0.0f;
  if (T > 1) {
#pragma unroll
    for (int ty = 0; ty < T; ++ty) {
      const double wy = s_w[fy * T + ty];
#pragma unroll
      for (int tx = 0; tx < T; ++tx) {
        float wv = __double2float_rn(__dmul_rn(wy, s_w[fx * T + tx]));
        if (MODE == 1) {  // absolute coordinates decide what lies outside
          const int yy = y0 + ly + ty;
          const int xx = x0 + lx + tx;
          if (yy < 0 || yy >= H || xx < 0 || xx >= W) {
            fill_w = __fadd_rn(fill_w, wv);
            wv = 0.0f;
          }
        }
        w[ty * T + tx] = wv;
      }
    }
  }
  const float fill_term = __fmul_rn(fill_w, fill);
  const uint8_t fill_u8 = t360::round_u8(fill);

  for (int f = 0; f < B; ++f) {
    const uint8_t* buf = bufs + (f & 1) * win_bytes;
    if (staged) {
      if (f + 1 < B) {
        stage<MODE>(src + (f + 1) * plane, bufs + ((f + 1) & 1) * win_bytes, y0,
                    x0, wh, pitch, H, W, vec);
        t360::cp_async_commit();
        t360::cp_async_wait<1>();
      } else {
        t360::cp_async_wait<0>();
      }
      __syncthreads();  // frame f's window is complete
    }
    if (active) {
      float acc = 0.0f;
      if (staged) {
        const uint8_t* s = buf + ly * pitch + lx;
#pragma unroll
        for (int ty = 0; ty < T; ++ty) {
#pragma unroll
          for (int tx = 0; tx < T; ++tx) {
            const float g = static_cast<float>(s[ty * pitch + tx]);
            if (T == 1) {
              acc = g;
            } else {
              const float term = __fmul_rn(w[ty * T + tx], g);
              acc = (ty == 0 && tx == 0) ? term : __fadd_rn(acc, term);
            }
          }
        }
      } else {
        const uint8_t* s = src + f * plane;
#pragma unroll
        for (int ty = 0; ty < T; ++ty) {
          const uint8_t* row = s + static_cast<size_t>(resolve<MODE>(y0 + ly + ty, H)) * W;
#pragma unroll
          for (int tx = 0; tx < T; ++tx) {
            const float g = static_cast<float>(row[resolve<MODE>(x0 + lx + tx, W)]);
            if (T == 1) {
              acc = g;
            } else {
              const float term = __fmul_rn(w[ty * T + tx], g);
              acc = (ty == 0 && tx == 0) ? term : __fadd_rn(acc, term);
            }
          }
        }
      }
      if (MODE == 1 && T > 1) acc = __fadd_rn(acc, fill_term);
      dst[static_cast<size_t>(f) * N + oy * out_w + ox] =
          invalid ? fill_u8 : t360::round_u8(acc);
    }
    if (staged) __syncthreads();  // buffer f & 1 is free for frame f + 2
  }
}

template <int T, int MODE>
int launch(const uint8_t* src, uint8_t* dst, int B, int H, int W, int out_h,
           int out_w, const int* meta, const uint32_t* pos, const uint8_t* fy,
           const uint8_t* fx, const double* w1, int first, int tiles,
           int win_bytes, float fill, bool vec, cudaStream_t st) {
  const int smem = kTableBytes + 2 * win_bytes;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        window_kernel<T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  window_kernel<T, MODE><<<tiles, kThreads, smem, st>>>(
      src, dst, B, H, W, out_h, out_w, meta, pos, fy, fx, w1, first, win_bytes,
      fill, vec);
  T360_CHECK_LAUNCH();
  return 0;
}

template <int T>
int launch_t(const uint8_t* src, uint8_t* dst, int B, int H, int W, int out_h,
             int out_w, const int* meta, const uint32_t* pos, const uint8_t* fy,
             const uint8_t* fx, const double* w1, int first, int tiles,
             int win_bytes, int mode, float fill, bool vec, cudaStream_t st) {
  switch (mode) {
    case 0:
      return launch<T, 0>(src, dst, B, H, W, out_h, out_w, meta, pos, fy, fx, w1,
                          first, tiles, win_bytes, fill, vec, st);
    case 1:
      return launch<T, 1>(src, dst, B, H, W, out_h, out_w, meta, pos, fy, fx, w1,
                          first, tiles, win_bytes, fill, vec, st);
    case 2:
      return launch<T, 2>(src, dst, B, H, W, out_h, out_w, meta, pos, fy, fx, w1,
                          first, tiles, win_bytes, fill, vec, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// src: uint8 [B, H, W]; dst: uint8 [B, out_h, out_w]; meta int32 [n, 6]
// (out row, out col, y0, x0, wh, pitch; pitch 0: global path); pos uint32,
// fy/fx uint8 [n * 256]; w1 float64 [32, taps].  Launches tiles
// first .. first + tiles - 1, each CTA with 2 * win_bytes of window
// buffers (win_bytes a multiple of 16).  vec: W and src are 16-aligned.
extern "C" int t360_window(const uint8_t* src, uint8_t* dst, int B, int H,
                           int W, int out_h, int out_w, const int* meta,
                           const uint32_t* pos, const uint8_t* fy,
                           const uint8_t* fx, const double* w1, int first,
                           int tiles, int win_bytes, int taps, int mode,
                           float fill, int vec, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || out_h <= 0 || out_w <= 0 || tiles <= 0 ||
      first < 0 || win_bytes < 0 || (win_bytes & 15) != 0 ||
      kTableBytes + 2 * win_bytes > 227 * 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool v = vec != 0;
  switch (taps) {
    case 1:
      return launch_t<1>(src, dst, B, H, W, out_h, out_w, meta, pos, fy, fx, w1,
                         first, tiles, win_bytes, mode, fill, v, st);
    case 2:
      return launch_t<2>(src, dst, B, H, W, out_h, out_w, meta, pos, fy, fx, w1,
                         first, tiles, win_bytes, mode, fill, v, st);
    case 4:
      return launch_t<4>(src, dst, B, H, W, out_h, out_w, meta, pos, fy, fx, w1,
                         first, tiles, win_bytes, mode, fill, v, st);
    case 8:
      return launch_t<8>(src, dst, B, H, W, out_h, out_w, meta, pos, fy, fx, w1,
                         first, tiles, win_bytes, mode, fill, v, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
