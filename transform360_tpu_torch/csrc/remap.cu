// K2: the uint8 remap on OpenCV's 1/32 grid, with the half-up round.
//
// Replaces the Pallas kernel transform360_tpu/ops/remap_lane.py:906
// (_make_lane_kernel, run by _run_lane_class, entry remap_lane_hwb), and
// the two pieces that complete it there: the XLA gather patch for tiles
// wider than every window class (_run_lane_fallback, remap_lane.py:1070)
// and the BORDER_TRANSPARENT partial-footprint fix-up
// (sampling.fixup_values, sampling.py:342).  It also serves the batch
// range of the pack-K and merged-window lane remaps (remap_lane.py:1097
// and :1266), which compute the same function with a TPU lane-occupancy
// tiling.  The pipeline routes plane batches of at most WINDOW_MAX_BATCH
// frames to K3 (window.cu, the port of remap_pallas.py:441), which
// computes the same function bit for bit, and larger batches here.
//
// Per output pixel n the plan gives the first-tap row/column
// (base_y/base_x, int32), the 1/32 fraction indices (fy/fx, uint8) and,
// for transparent layouts, a valid mask.  wtab [32*32, T*T] holds the
// combined weight float32(wy*wx) (float64 product, as tap_arrays builds
// it) for every fraction pair, so the sum below -- ty-major, tx-minor,
// each product and each sum rounded on its own (-fmad=false; the
// __fmul_rn/__fadd_rn intrinsics are never contracted) -- is bit-identical
// to the plain version transform360_tpu_torch.sampling.remap_plain.
// Border rules (the semantics of sampling.tap_arrays):
//   mode 0 BORDER_WRAP   taps wrap modulo the plane (the flagship);
//   mode 1 BORDER_FILL   linear/cubic taps outside the plane weigh 0 and
//                        their weight times the fill is added last;
//   mode 2 BORDER_REFLECT lanczos4 taps outside read BORDER_REFLECT_101;
// and pixels whose valid byte is 0 take the fill.  So there is no
// separate fallback or fix-up pass.
//
// What bounds it on the H100: latency of dependent gathers and bytes.
// Each output pixel reads T*T input bytes scattered over T rows, plus
// 10 B of plan (16 MB for the 4K->1536x1024 luma map).  The TPU kernel
// keeps 128 frames in the vector lanes so one index serves 128 frames;
// the Hopper counterpart is one thread per output pixel that loops over
// a chunk of frames (kFrames), reusing its indices and weights from
// registers, so the plan is read once per chunk, not once per frame.
// Neighbouring threads take neighbouring output pixels, whose footprints
// overlap, so the gathers mostly hit L1/L2.

#include "common.cuh"

namespace {

constexpr int kBlock = 256;
constexpr int kFrames = 8;  // frames per thread
constexpr int kTab = 32;    // INTER_TAB_SIZE

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

template <int T, int MODE>
__global__ void remap_kernel(const uint8_t* __restrict__ src,
                             uint8_t* __restrict__ dst, int B, int H, int W,
                             int N, const int* __restrict__ base_y,
                             const int* __restrict__ base_x,
                             const uint8_t* __restrict__ fy,
                             const uint8_t* __restrict__ fx,
                             const uint8_t* __restrict__ valid,
                             const float* __restrict__ wtab, float fill) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= N) return;
  const int f0 = blockIdx.y * kFrames;
  const int f1 = min(f0 + kFrames, B);
  const size_t plane = static_cast<size_t>(H) * W;

  if (valid != nullptr && valid[n] == 0) {
    const uint8_t v = t360::round_u8(fill);
    for (int f = f0; f < f1; ++f) dst[static_cast<size_t>(f) * N + n] = v;
    return;
  }

  const int by = base_y[n];
  const int bx = base_x[n];
  int rows[T];
  int cols[T];
  for (int t = 0; t < T; ++t) {
    rows[t] = resolve<MODE>(by + t, H) * W;
    cols[t] = resolve<MODE>(bx + t, W);
  }
  float w[T * T];
  float fill_w = 0.0f;
  const float* wt = wtab + (static_cast<int>(fy[n]) * kTab + fx[n]) * (T * T);
  for (int ty = 0; ty < T; ++ty) {
    for (int tx = 0; tx < T; ++tx) {
      float wv = wt[ty * T + tx];
      if (MODE == 1 && T > 1) {
        const int yy = by + ty;
        const int xx = bx + tx;
        if (yy < 0 || yy >= H || xx < 0 || xx >= W) {
          fill_w = __fadd_rn(fill_w, wv);
          wv = 0.0f;
        }
      }
      w[ty * T + tx] = wv;
    }
  }
  const float fill_term = __fmul_rn(fill_w, fill);

  for (int f = f0; f < f1; ++f) {
    const uint8_t* s = src + static_cast<size_t>(f) * plane;
    float acc;
    if (T == 1) {
      acc = static_cast<float>(s[rows[0] + cols[0]]);
    } else {
      acc = 0.0f;
#pragma unroll
      for (int ty = 0; ty < T; ++ty) {
#pragma unroll
        for (int tx = 0; tx < T; ++tx) {
          const float g = static_cast<float>(s[rows[ty] + cols[tx]]);
          const float term = __fmul_rn(w[ty * T + tx], g);
          acc = (ty == 0 && tx == 0) ? term : __fadd_rn(acc, term);
        }
      }
      if (MODE == 1) acc = __fadd_rn(acc, fill_term);
    }
    dst[static_cast<size_t>(f) * N + n] = t360::round_u8(acc);
  }
}

template <int T>
int launch_t(const uint8_t* src, uint8_t* dst, int B, int H, int W, int N,
             const int* base_y, const int* base_x, const uint8_t* fy,
             const uint8_t* fx, const uint8_t* valid, const float* wtab,
             int mode, float fill, cudaStream_t st) {
  const dim3 block(kBlock);
  const dim3 grid((N + kBlock - 1) / kBlock, (B + kFrames - 1) / kFrames);
  switch (mode) {
    case 0:
      remap_kernel<T, 0><<<grid, block, 0, st>>>(src, dst, B, H, W, N, base_y,
                                                 base_x, fy, fx, valid, wtab,
                                                 fill);
      break;
    case 1:
      remap_kernel<T, 1><<<grid, block, 0, st>>>(src, dst, B, H, W, N, base_y,
                                                 base_x, fy, fx, valid, wtab,
                                                 fill);
      break;
    case 2:
      remap_kernel<T, 2><<<grid, block, 0, st>>>(src, dst, B, H, W, N, base_y,
                                                 base_x, fy, fx, valid, wtab,
                                                 fill);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  T360_CHECK_LAUNCH();
  return 0;
}

}  // namespace

// src: uint8 [B, H, W]; dst: uint8 [B, N] (N = out_h * out_w);
// base_y/base_x int32 [N]; fy/fx uint8 [N]; valid uint8 [N] or NULL;
// wtab float32 [1024, taps*taps].
extern "C" int t360_remap(const uint8_t* src, uint8_t* dst, int B, int H,
                          int W, int N, const int* base_y, const int* base_x,
                          const uint8_t* fy, const uint8_t* fx,
                          const uint8_t* valid, const float* wtab, int taps,
                          int mode, float fill, void* stream) {
  if (B <= 0 || N <= 0 || H <= 0 || W <= 0 ||
      (B + kFrames - 1) / kFrames > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (taps) {
    case 1:
      return launch_t<1>(src, dst, B, H, W, N, base_y, base_x, fy, fx, valid,
                         wtab, mode, fill, st);
    case 2:
      return launch_t<2>(src, dst, B, H, W, N, base_y, base_x, fy, fx, valid,
                         wtab, mode, fill, st);
    case 4:
      return launch_t<4>(src, dst, B, H, W, N, base_y, base_x, fy, fx, valid,
                         wtab, mode, fill, st);
    case 8:
      return launch_t<8>(src, dst, B, H, W, N, base_y, base_x, fy, fx, valid,
                         wtab, mode, fill, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
