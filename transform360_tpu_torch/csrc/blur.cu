// K1: the adaptive low-pass prefilter, with the half-up round, in one fused
// pass through shared memory, for uint8 planes and for uint16 planes (the
// 10-, 12- and 16-bit formats, saturated at the depth's maximum).
//
// Replaces the Pallas kernel transform360_tpu/ops/blur_lane.py:269
// (_make_kernel, entry blur_lane).  It computes what
// transform360_tpu.filtering.apply_blur followed by pipeline._round_u8
// computes, and what transform360_tpu_torch.filtering.blur_plain + round
// computes, bit for bit; its uint16 instantiation computes what apply_blur
// followed by pipeline._round_px computes on the JAX package's XLA path,
// which the deep formats took because B1 is uint8-only.  For output pixel
// (r, c) of latitude band g and blur segment s: h_t = sum_u kx[g,s][u] * x[clamp(r - ry + t)][clamp(c + u - rx)]
// for t = 0 .. 2*ry, then sum_t ky[g,s][t] * h_t, then the round; u and t
// ascend, and each product and each sum is rounded on its own (built with
// -fmad=false; __fmul_rn/__fadd_rn are never contracted).  Each h_t is the
// x pass of its source row with the OUTPUT row's band taps, also for halo
// rows across a band seam, as apply_blur slices rows
// [top - ry, top + height + ry) per band.  Rows and columns outside the
// plane clamp to its edge; seams between bands, segments and stereo eyes
// read their real neighbours.  The TPU kernel keeps 128 frames in the
// vector lanes and runs the x pass as a banded Toeplitz matmul on the MXU;
// both are TPU artifacts and are not carried over: here planes are
// batch-major [B, H, W] of uint8 or uint16 samples.
//
// What bounds it on the H100.  The compulsory traffic is 2 bytes per pixel
// (uint8 in, uint8 out; 4 at uint16); the work is (2*rx+1) + (2*ry+1)
// products and as many sums per pixel, a few float32 operations per byte,
// so bytes and float32 issue are within a factor of about two of each
// other at the flagship (rx 1..6, ry 1).  The design keeps everything
// between the two planes on chip:
//   * the host (ops/blur.py, BlurTables) cuts the plane into tiles of at
//     most 8*strip rows x 128 columns that never cross a band, a segment or
//     an eye, so a tile has one set of taps (row `set` of kx/ky); zero
//     tiles (set -1) write the leftover row or column of odd stereo dims;
//   * a CTA of 8 warps stages its tile's source rows
//     [r0 - RY, r0 + nrows + RY) x columns [xs, xs + pitch) in shared
//     memory (16-byte cp.async inside the plane, sample by sample where a
//     chunk is clamped), double-buffered across the frames it loops over;
//     pitch counts samples, and the host sizes the tiles so that two
//     buffers fit in shared memory at either sample size;
//   * each thread owns 4 adjacent columns of one warp's strip of rows and
//     walks down it: per source row it reads its samples as aligned words
//     (4 bytes or 2 halves each), funnel-shifts them into place, turns
//     each into a float with two full-rate instructions (0x4B0000bb and
//     0x4B00hhll are 2^23 + the sample), runs the x pass (unrolled for
//     rx <= 8, a sliding window beyond), and keeps the last 2*RY + 1
//     results in a register ring; the y pass, the round and one 4-byte
//     (uint16: 8-byte) store follow.  No float32 value touches device
//     memory.
// A plan's y radius is padded up to the ring's RY (1 or 3) with zero taps,
// which changes no bit (0 * h = +0, and adding +0 leaves a sum as it is).
// Plans with a larger y radius, or an x radius whose staged rows would not
// fit in shared memory, take blur_direct_kernel: the same tiles, one thread
// per pixel, every tap read through L1.  Either way it is one launch per
// call, with no scratch and no chunking of the batch.

#include "common.cuh"

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kV = 4;  // adjacent output columns per thread: one 4- or 8-byte store

// log2 of the samples in a 32-bit word and in a 16-byte chunk: 2 and 4
// for uint8 samples, 1 and 3 for uint16.
template <typename S>
constexpr int kLogWord = sizeof(S) == 1 ? 2 : 1;
template <typename S>
constexpr int kLogChunk = kLogWord<S> + 2;

using t360::sample_to_float;

// t360::round_u8 as an integer: floor(x + 0.5) saturated to [0, 255], or
// to maxval for uint16 samples.
template <typename S>
__device__ __forceinline__ uint32_t round_to_sample(float x, int maxval) {
  return static_cast<uint32_t>(
      min(max(__float2int_rd(__fadd_rn(x, 0.5f)), 0), sizeof(S) == 1 ? 255 : maxval));
}

// Copy rows [y0, y0 + rows) x columns [xs, xs + pitch) of one frame into
// buf (row i at buf + i * pitch), clamped to the plane.
template <typename S>
__device__ __forceinline__ void stage(const S* __restrict__ frame, S* buf, int y0, int xs,
                                      int rows, int pitch, int H, int W, bool vec) {
  constexpr int lc = kLogChunk<S>;
  const int cpr = pitch >> lc;
  const int n = rows * cpr;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = i / cpr;
    const int k = (i - r * cpr) << lc;
    const int gx = xs + k;
    const S* row = frame + static_cast<size_t>(t360::clamp_idx(y0 + r, H)) * W;
    S* d = buf + r * pitch + k;
    if (vec && gx >= 0 && gx + (1 << lc) <= W) {
      t360::cp_async16(d, row + gx);
    } else {
#pragma unroll
      for (int j = 0; j < (1 << lc); ++j) d[j] = row[t360::clamp_idx(gx + j, W)];
    }
  }
}

// The x pass of kV adjacent columns whose first tap is sample b of row:
// h[c] = sum_u k[u] * row[b + c + u], u ascending.
template <typename S, int RX>
__device__ __forceinline__ void x_pass(const S* row, int b, const float* k, float* h) {
  constexpr int lw = kLogWord<S>;
  constexpr int P = 1 << lw;  // samples per word
  constexpr int N = kV + 2 * RX;  // samples read
  constexpr int NQ = (N + P - 1) / P;
  const uint32_t* w = reinterpret_cast<const uint32_t*>(row + (b & ~(P - 1)));
  const int s = (b & (P - 1)) * 8 * static_cast<int>(sizeof(S));
  uint32_t a[NQ + 1];
#pragma unroll
  for (int i = 0; i <= NQ; ++i) a[i] = w[i];
  float p[P * NQ];
#pragma unroll
  for (int i = 0; i < NQ; ++i) {
    const uint32_t v = __funnelshift_r(a[i], a[i + 1], s);
#pragma unroll
    for (int j = 0; j < P; ++j) p[P * i + j] = sample_to_float<S>(v, j);
  }
#pragma unroll
  for (int c = 0; c < kV; ++c) {
    float acc = __fmul_rn(k[0], p[c]);
#pragma unroll
    for (int u = 1; u <= 2 * RX; ++u) acc = __fadd_rn(acc, __fmul_rn(k[u], p[c + u]));
    h[c] = acc;
  }
}

// The same for any radius: a window of kV samples slides over the taps.
template <typename S>
__device__ __forceinline__ void x_pass_any(const S* row, int b, const float* __restrict__ k,
                                           int rx, float* h) {
  float p[kV];
  const float k0 = k[0];
#pragma unroll
  for (int c = 0; c < kV; ++c) {
    p[c] = sample_to_float<S>(row[b + c], 0);
    h[c] = __fmul_rn(k0, p[c]);
  }
  for (int u = 1; u <= 2 * rx; ++u) {
#pragma unroll
    for (int c = 0; c < kV - 1; ++c) p[c] = p[c + 1];
    p[kV - 1] = sample_to_float<S>(row[b + u + kV - 1], 0);
    const float ku = k[u];
#pragma unroll
    for (int c = 0; c < kV; ++c) h[c] = __fadd_rn(h[c], __fmul_rn(ku, p[c]));
  }
}

template <typename S>
__device__ void zero_tile(S* __restrict__ out, int f0, int nf, size_t plane, int W, int r0,
                          int c0, int nrows, int ncols) {
  const int n = nrows * ncols;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const size_t o = static_cast<size_t>(r0 + i / ncols) * W + c0 + i % ncols;
    for (int f = f0; f < f0 + nf; ++f) out[f * plane + o] = 0;
  }
}

struct Tile {
  int r0, c0, nrows, ncols, pitch, rx;
};

// 4 samples of one output row in one store of 4 (uint8) or 8 bytes.
__device__ __forceinline__ void store4(uint8_t* d, const uint32_t* v) {
  *reinterpret_cast<uint32_t*>(d) = v[0] | (v[1] << 8) | (v[2] << 16) | (v[3] << 24);
}
__device__ __forceinline__ void store4(uint16_t* d, const uint32_t* v) {
  *reinterpret_cast<uint2*>(d) = make_uint2(v[0] | (v[1] << 16), v[2] | (v[3] << 16));
}

// One tile over frames f0 .. f0 + nf - 1.  RX < 0: any x radius (rx).
// k: the tile's 2*rx+1 x taps; q: its 2*RY+1 y taps (zero-padded).
template <typename S, int RX, int RY>
__device__ __forceinline__ void ring_tile(const S* __restrict__ x, S* __restrict__ out,
                                          int f0, int nf, int H, int W, const Tile& t,
                                          const float* __restrict__ k,
                                          const float* __restrict__ q, uint8_t* bufs,
                                          int buf_bytes, int maxval, bool vec_in,
                                          bool vec_out) {
  const size_t plane = static_cast<size_t>(H) * W;
  // 16-byte-aligned first staged column
  const int xs = (t.c0 - t.rx) & ~((1 << kLogChunk<S>) - 1);
  const int rows = t.nrows + 2 * RY;
  const int warp = threadIdx.x >> 5;
  const int col = (threadIdx.x & 31) * kV;
  const int sh = (t.nrows + kWarps - 1) / kWarps;  // rows per warp strip
  const int sr = warp * sh;
  const int nr = min(sh, t.nrows - sr);
  const bool active = nr > 0 && col < t.ncols;
  const int b = t.c0 - t.rx - xs + col;  // first tap's sample in a staged row
  const bool vec_store = vec_out && (t.c0 & 3) == 0 && col + kV <= t.ncols;

  float kr[RX >= 0 ? 2 * RX + 1 : 1];
  if (RX >= 0) {
#pragma unroll
    for (int u = 0; u < (RX >= 0 ? 2 * RX + 1 : 1); ++u) kr[u] = k[u];
  }
  float qr[2 * RY + 1];
#pragma unroll
  for (int i = 0; i <= 2 * RY; ++i) qr[i] = q[i];

  stage<S>(x + f0 * plane, reinterpret_cast<S*>(bufs), t.r0 - RY, xs, rows, t.pitch, H, W,
           vec_in);
  t360::cp_async_commit();
  for (int f = 0; f < nf; ++f) {
    if (f + 1 < nf) {
      S* next = reinterpret_cast<S*>(bufs + ((f + 1) & 1) * buf_bytes);
      stage<S>(x + (f0 + f + 1) * plane, next, t.r0 - RY, xs, rows, t.pitch, H, W, vec_in);
      t360::cp_async_commit();
      t360::cp_async_wait<1>();
    } else {
      t360::cp_async_wait<0>();
    }
    __syncthreads();  // frame f's rows are staged
    if (active) {
      const S* src = reinterpret_cast<const S*>(bufs + (f & 1) * buf_bytes) + sr * t.pitch;
      S* dst = out + (f0 + f) * plane + static_cast<size_t>(t.r0 + sr) * W + t.c0 + col;
      float ring[2 * RY + 1][kV] = {};
      for (int i = 0; i < nr + 2 * RY; ++i) {
#pragma unroll
        for (int j = 0; j < 2 * RY; ++j) {
#pragma unroll
          for (int c = 0; c < kV; ++c) ring[j][c] = ring[j + 1][c];
        }
        if (RX >= 0) {
          x_pass<S, (RX >= 0 ? RX : 0)>(src + i * t.pitch, b, kr, ring[2 * RY]);
        } else {
          x_pass_any<S>(src + i * t.pitch, b, k, t.rx, ring[2 * RY]);
        }
        if (i < 2 * RY) continue;
        uint32_t v[kV];
#pragma unroll
        for (int c = 0; c < kV; ++c) {
          float acc = __fmul_rn(qr[0], ring[0][c]);
#pragma unroll
          for (int j = 1; j <= 2 * RY; ++j) acc = __fadd_rn(acc, __fmul_rn(qr[j], ring[j][c]));
          v[c] = round_to_sample<S>(acc, maxval);
        }
        S* d = dst + static_cast<size_t>(i - 2 * RY) * W;
        if (vec_store) {
          store4(d, v);
        } else {
#pragma unroll
          for (int c = 0; c < kV; ++c) {
            if (col + c < t.ncols) d[c] = static_cast<S>(v[c]);
          }
        }
      }
    }
    __syncthreads();  // buffer f & 1 is free for frame f + 2
  }
}

// tiles: int32 [n, 6] = (r0, c0, nrows, ncols, set, pitch in samples);
// blockIdx.x is the tile, blockIdx.y the group of fpc frames.
template <typename S, int RY>
__global__ void __launch_bounds__(kThreads, 3)
    blur_ring_kernel(const S* __restrict__ x, S* __restrict__ out, int B, int H, int W,
                     const int* __restrict__ tiles, const float* __restrict__ kx,
                     const int* __restrict__ rx_of, int lx, const float* __restrict__ ky,
                     int ly, int fpc, int buf_bytes, int maxval, bool vec_in, bool vec_out) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int* m = tiles + 6 * blockIdx.x;
  const int f0 = blockIdx.y * fpc;
  const int nf = min(fpc, B - f0);
  const int set = m[4];
  if (set < 0) {  // uniform over the CTA
    zero_tile(out, f0, nf, static_cast<size_t>(H) * W, W, m[0], m[1], m[2], m[3]);
    return;
  }
  const Tile t{m[0], m[1], m[2], m[3], m[5], rx_of[set]};
  const float* k = kx + static_cast<size_t>(set) * lx + (lx - 1) / 2 - t.rx;
  const float* q = ky + static_cast<size_t>(set) * ly + (ly - 1) / 2 - RY;
  switch (t.rx) {
#define T360_RX(R)                                                                      \
  case R:                                                                               \
    ring_tile<S, R, RY>(x, out, f0, nf, H, W, t, k, q, smem, buf_bytes, maxval, vec_in, \
                        vec_out);                                                       \
    break;
    T360_RX(0)
    T360_RX(1)
    T360_RX(2)
    T360_RX(3)
    T360_RX(4)
    T360_RX(5)
    T360_RX(6)
    T360_RX(7)
    T360_RX(8)
#undef T360_RX
    default:
      ring_tile<S, -1, RY>(x, out, f0, nf, H, W, t, k, q, smem, buf_bytes, maxval, vec_in,
                           vec_out);
  }
}

// Any radius: one thread per output pixel of the tile, every tap read
// through L1, in the same order.
template <typename S>
__global__ void __launch_bounds__(kThreads)
    blur_direct_kernel(const S* __restrict__ x, S* __restrict__ out, int B, int H, int W,
                       const int* __restrict__ tiles, const float* __restrict__ kx,
                       const int* __restrict__ rx_of, int lx, const float* __restrict__ ky,
                       const int* __restrict__ ry_of, int ly, int fpc, int maxval) {
  const int* m = tiles + 6 * blockIdx.x;
  const int r0 = m[0], c0 = m[1], nrows = m[2], ncols = m[3], set = m[4];
  const int f0 = blockIdx.y * fpc;
  const int nf = min(fpc, B - f0);
  const size_t plane = static_cast<size_t>(H) * W;
  if (set < 0) {
    zero_tile(out, f0, nf, plane, W, r0, c0, nrows, ncols);
    return;
  }
  const int rx = rx_of[set], ry = ry_of[set];
  const float* k = kx + static_cast<size_t>(set) * lx + (lx - 1) / 2 - rx;
  const float* q = ky + static_cast<size_t>(set) * ly + (ly - 1) / 2 - ry;
  const int n = nrows * ncols;
  for (int i = threadIdx.x; i < n; i += kThreads) {
    const int r = r0 + i / ncols;
    const int c = c0 + i % ncols;
    for (int f = f0; f < f0 + nf; ++f) {
      const S* frame = x + f * plane;
      float acc = 0.0f;
      for (int j = 0; j <= 2 * ry; ++j) {
        const S* row = frame + static_cast<size_t>(t360::clamp_idx(r - ry + j, H)) * W;
        float h = 0.0f;
        for (int u = 0; u <= 2 * rx; ++u) {
          const float term =
              __fmul_rn(k[u], static_cast<float>(row[t360::clamp_idx(c + u - rx, W)]));
          h = (u == 0) ? term : __fadd_rn(h, term);
        }
        const float term = __fmul_rn(q[j], h);
        acc = (j == 0) ? term : __fadd_rn(acc, term);
      }
      out[f * plane + static_cast<size_t>(r) * W + c] =
          static_cast<S>(round_to_sample<S>(acc, maxval));
    }
  }
}

template <typename S, int RY>
int launch_ring(const S* x, S* out, int B, int H, int W, const int* tiles, dim3 grid,
                const float* kx, const int* rx, int lx, const float* ky, int ly, int fpc,
                int buf_bytes, int maxval, bool vec_in, bool vec_out, cudaStream_t st) {
  const int smem = 2 * buf_bytes;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        blur_ring_kernel<S, RY>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  blur_ring_kernel<S, RY><<<grid, kThreads, smem, st>>>(x, out, B, H, W, tiles, kx, rx, lx,
                                                        ky, ly, fpc, buf_bytes, maxval,
                                                        vec_in, vec_out);
  T360_CHECK_LAUNCH();
  return 0;
}

template <typename S>
int launch(const S* x, S* out, int B, int H, int W, const int* tiles, int n_tiles,
           const float* kx, const int* rx, int lx, const float* ky, const int* ry, int ly,
           int ring_ry, int fpc, int buf_bytes, int maxval, bool vi, bool vo,
           cudaStream_t st) {
  const dim3 grid(n_tiles, (B + fpc - 1) / fpc);
  switch (ring_ry) {
    case -1:
      blur_direct_kernel<S><<<grid, kThreads, 0, st>>>(x, out, B, H, W, tiles, kx, rx, lx,
                                                       ky, ry, ly, fpc, maxval);
      T360_CHECK_LAUNCH();
      return 0;
    case 1:
      return launch_ring<S, 1>(x, out, B, H, W, tiles, grid, kx, rx, lx, ky, ly, fpc,
                               buf_bytes, maxval, vi, vo, st);
    case 3:
      return launch_ring<S, 3>(x, out, B, H, W, tiles, grid, kx, rx, lx, ky, ly, fpc,
                               buf_bytes, maxval, vi, vo, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// x, out: [B, H, W] samples of sample_bytes each (1: uint8; 2: uint16,
// rounded and saturated to maxval, the depth's largest sample); tiles:
// int32 [n_tiles, 6]; kx float32 [sets, lx] and ky [sets, ly], each set's
// taps centred; rx/ry int32 [sets].  ring_ry: 1 or 3 for the
// register-ring kernel (ly = 2*ring_ry+1), -1 for the direct kernel.  Each
// CTA loops over fpc frames and holds two staged buffers of buf_bytes
// (ring kernel).  vec_in: W and x 16-byte aligned; vec_out: W a multiple
// of 4 and out aligned to 4 samples.
extern "C" int t360_blur(const void* x, void* out, int sample_bytes, int maxval, int B,
                         int H, int W, const int* tiles, int n_tiles, const float* kx,
                         const int* rx, int lx, const float* ky, const int* ry, int ly,
                         int ring_ry, int fpc, int buf_bytes, int vec_in, int vec_out,
                         void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || n_tiles <= 0 || fpc <= 0 ||
      (B + fpc - 1) / fpc > 65535 || buf_bytes < 0 || (buf_bytes & 15) != 0 ||
      2 * buf_bytes > 227 * 1024 ||
      (sample_bytes == 1 ? maxval != 255
                         : sample_bytes != 2 || maxval < 255 || maxval > 65535))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vi = vec_in != 0, vo = vec_out != 0;
  if (sample_bytes == 1)
    return launch(static_cast<const uint8_t*>(x), static_cast<uint8_t*>(out), B, H, W, tiles,
                  n_tiles, kx, rx, lx, ky, ry, ly, ring_ry, fpc, buf_bytes, maxval, vi, vo,
                  st);
  return launch(static_cast<const uint16_t*>(x), static_cast<uint16_t*>(out), B, H, W, tiles,
                n_tiles, kx, rx, lx, ky, ry, ly, ring_ry, fpc, buf_bytes, maxval, vi, vo, st);
}
