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
// -- bit for bit: per output pixel (r, c) and for ascending column tap q,
// the row pass h = sum over ascending p of float(x[ri[r,p], ci[c,q]]) *
// rw[r,p] (the p = 0 product itself, then each product added), times
// cw[c,q], summed in ascending q; every product and every sum is rounded
// on its own (-fmad=false, __fmul_rn/__fadd_rn), then floor(s + 0.5) is
// clamped to [0, maxval].  Tap indices are first + k clamped into the
// input, as AreaAxis.indices gives them; the zero-weight padding taps add
// +0 to a sum of non-negative terms, which changes no bit, so they run.
//
// What bounds it on the H100: bytes, and at uint8 the instructions that
// turn them into sums.  At the 2x2 flagship a 3072x2048 luma frame (6.3
// MB) becomes 1536x1024 (1.6 MB) with about 9 float operations per output
// pixel against at least 5 bytes moved, so the card must keep enough bytes
// in flight to cover the memory's latency from the first frame of a
// launch to its last, and issue few instructions per sample.  The design
// (port_tools/k4_check.py times each choice against the others):
//
// * Persistent CTAs.  The grid is the CTAs resident on every SM (3 per SM:
//   T360_AREA_MIN_BLOCKS caps the registers at 72, where the 2-tap
//   instantiations do not spill).  Each CTA walks its share of the plan's (tile, frame) items --
//   8x128 output tiles, ops/area.py -- each tile's frames in order, so its
//   taps stay in registers: a contiguous run of the tile-major items
//   (order 0), or on planes whose rows are not whole 128-byte lines every
//   P-th tile (order 1: the CTAs then take adjacent tiles at one frame at
//   a time and share the lines that straddle two tiles).  Only a CTA's
//   first load has nothing to overlap it.
// * A ring of shared-memory stages fed by one producer warp.  Each stage
//   holds one item's input span, as `nbox` boxes of `box_h` rows by
//   `box_w` samples (box-major; a box row is at most 256 samples, TMA's
//   limit).  On a plane whose rows are 16-byte aligned one lane of the
//   producer warp issues a TMA copy per box (cp.async.bulk.tensor.3d, a
//   (column, row, frame) box of a CUtensorMap encoded on the host at each
//   launch) that completes on the stage's `full` mbarrier; the eight
//   consumer warps spend no instruction on copies.  Each consumer warp
//   arrives on the stage's `empty` mbarrier when it has read it, and the
//   producer reuses a stage only after all eight did, running up to
//   `stages` items (4) ahead, across tile boundaries.  A plane whose rows
//   are not 16-byte aligned, which TMA cannot address, is staged by every
//   thread of the CTA with plain loads between two CTA barriers (the
//   plan's choice, by shape; never a fallback).
// * Packed taps.  On a tile where every output column's taps are K
//   consecutive samples with one weight (whole-number factors, K = 2 or 4,
//   marked by the plan), each consumer thread takes 4 adjacent outputs:
//   per tap row one 8- to 32-byte shared load of its 4K samples, bytes or
//   halves to floats by PRMT into 0x4B0000bb and one subtract (no I2F),
//   and one 32- or 64-bit store of its 4 outputs.  Other tiles (fractional
//   factors such as 1.5x2) take one output column in 32 per lane (lane +
//   32 j, so neighbouring lanes read neighbouring samples) with per-column
//   tap offsets and weights in registers.  The round is floor by a
//   round-down add of 2^23 and an integer min, no F2I.
// * Tiles of a plan with more than 4 taps on an axis, or whose span
//   exceeds the ring's budget (large factors such as 8x), are direct: they
//   read device memory in the consumer warps and take no stage.

#include "common.cuh"

#ifndef T360_AREA_MIN_BLOCKS
#define T360_AREA_MIN_BLOCKS 3  // resident CTAs per SM the registers must allow
#endif

namespace {

constexpr int kTR = 8, kTC = 128;  // output tile rows, columns
constexpr int kWarps = kTR;        // consumer warps: one per output row
constexpr int kThreads = 32 * (kWarps + 1);  // and the producer warp
constexpr int kMaxStages = 8;
static_assert(kTC == 4 * 32, "4 columns per lane");

enum Copy { kTma = 0, kAsync = 1, kScalar = 2 };  // how a stage is filled
enum Mode { kDirect = 0, kStaged = 1, kPacked = 2 };  // a tile's path (its row's last entry)

struct Args {
  const void* src;        // [B, H, W]
  void* dst;              // [B, OH, OW]
  const int* tiles;       // [n, 8]: r0, c0, rows, cols, y0, x0, span rows, Mode
  const int* row_first;   // [OH]
  const float* row_w;     // [OH, kr]
  const int* col_first;   // [OW]
  const float* col_w;     // [OW, kc]
  int B, H, W, OH, OW, kr, kc, n_tiles;
  int box_w, box_h, nbox;  // a stage: nbox boxes of box_h rows of box_w samples
  int stage_bytes;         // a stage's bytes, a multiple of 128
  int stages;              // the ring's depth
  int copy;                // Copy
  int packed;              // take the packed path on the tiles marked for it
  int order;               // the items' walk (Item)
  unsigned maxval;
};

// A CTA's walk over its (tile, frame) items, each tile's frames in order
// (ops.area.work_list).  order 0: the contiguous run [i T / P, (i + 1) T /
// P) of the T = n_tiles x B items in tile-major order (CTA i of P); order
// 1: the tiles i, i + P, i + 2 P, ..., all frames of each, so that the P
// CTAs take P adjacent tiles at one frame at a time.
struct Item {
  int tile, f, left, step;  // left: items still to walk; step: tiles to the next
  __device__ explicit Item(const Args& a) {
    const int P = gridDim.x, i = blockIdx.x;
    if (a.order == 0) {
      const long long T = static_cast<long long>(a.n_tiles) * a.B;
      const int t0 = static_cast<int>(i * T / P), t1 = static_cast<int>((i + 1) * T / P);
      tile = t0 / a.B, f = t0 - tile * a.B, left = t1 - t0, step = 1;
    } else {
      tile = i, f = 0, step = P;
      left = i < a.n_tiles ? (a.n_tiles - 1 - i) / P * a.B + a.B : 0;
    }
  }
  __device__ void next(const Args& a) {
    --left;
    if (++f == a.B) f = 0, tile += step;
  }
};

using t360::mbar_arrive;
using t360::mbar_arrive_cp_async;
using t360::mbar_expect_tx;
using t360::mbar_init;
using t360::mbar_wait;
using t360::round_bits;
using t360::smem_u32;
using t360::tma_load;

// The exact float value of a sample (< 2^23): 0x4B000000 | v is 2^23 + v.
__device__ __forceinline__ float sample_float(uint32_t v) {
  return __fsub_rn(__uint_as_float(0x4B000000u | v), 8388608.0f);
}

// Offset in a stage of the span's sample (row, col), both relative to
// the span's origin: boxes of box_h rows of box_w samples, box-major.
__device__ __forceinline__ int stage_offset(const Args& a, int row, int col) {
  const int box = col / a.box_w;
  return (box * a.box_h + row) * a.box_w + (col - box * a.box_w);
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

// The producer warp: fills a stage for each staged item of its CTA, in
// order, by TMA or cp.async, waiting for the stage's consumers of
// `stages` items before.
template <typename S>
__device__ __forceinline__ void produce(const CUtensorMap* map, const Args& a, unsigned char* ring,
                                        uint64_t* full, uint64_t* empty) {
  const int lane = threadIdx.x & 31;
  const size_t plane = static_cast<size_t>(a.H) * a.W;
  const S* src = static_cast<const S*>(a.src);
  const unsigned box_bytes = a.box_w * a.box_h * sizeof(S);
  int s = 0, cur = -1;
  unsigned phase = 0;
  int y0 = 0, x0 = 0, span = 0, mode = kDirect;
  for (Item it(a); it.left > 0; it.next(a)) {
    const int tile = it.tile, f = it.f;
    if (tile != cur) {
      const int* tl = a.tiles + tile * 8;
      y0 = __ldg(tl + 4), x0 = __ldg(tl + 5), span = __ldg(tl + 6), mode = __ldg(tl + 7);
      cur = tile;
    }
    if (mode == kDirect) continue;
    mbar_wait(&empty[s], phase ^ 1);  // its consumers of `stages` items before are done
    unsigned char* buf = ring + s * a.stage_bytes;
    if (a.copy == kTma) {
      if (lane == 0) {
        mbar_expect_tx(&full[s], a.nbox * box_bytes);
        for (int i = 0; i < a.nbox; ++i)
          tma_load(buf + i * box_bytes, map, &full[s], x0 + i * a.box_w, y0, f);
      }
    } else {  // 16-byte cp.async chunks; the rows and columns are whole chunks here
      constexpr int kChunk = 16 / sizeof(S);
      const S* base = src + f * plane + static_cast<size_t>(y0) * a.W + x0;
      const int per_row = min(a.box_w * a.nbox, a.W - x0) / kChunk;  // none past the width
      S* sbuf = reinterpret_cast<S*>(buf);
      for (int i = lane; i < span * per_row; i += 32) {
        const int row = i / per_row, col = (i - row * per_row) * kChunk;
        t360::cp_async16(sbuf + stage_offset(a, row, col), base + row * a.W + col);
      }
      mbar_arrive_cp_async(&full[s]);
    }
    if (++s == a.stages) s = 0, phase ^= 1;
  }
}

// Every thread of the CTA stages one item's span (base: its first sample
// in the frame, x0 its column) with plain loads: 32-bit words when the
// rows and the plane are 4-byte aligned, else sample by sample.  The
// columns at or past the plane's width are not loaded (no tap reads them).
template <typename S>
__device__ __forceinline__ void stage_all(const Args& a, unsigned char* buf, const S* base,
                                          int span, int x0, bool words) {
  const int cols = min(a.box_w * a.nbox, a.W - x0);
  if (words) {  // cols and W are whole words here
    constexpr int kPer = 4 / sizeof(S);
    const int per_row = cols / kPer;
    for (int i = threadIdx.x; i < span * per_row; i += kThreads) {
      const int row = i / per_row, col = (i - row * per_row) * kPer;
      *reinterpret_cast<uint32_t*>(buf + stage_offset(a, row, col) * sizeof(S)) =
          __ldg(reinterpret_cast<const uint32_t*>(base + static_cast<size_t>(row) * a.W + col));
    }
  } else {
    for (int i = threadIdx.x; i < span * cols; i += kThreads) {
      const int row = i / cols, col = i - row * cols;
      reinterpret_cast<S*>(buf)[stage_offset(a, row, col)] =
          __ldg(base + static_cast<size_t>(row) * a.W + col);
    }
  }
}

// A packed row of a lane: 4 K samples as 32-bit words, from one 8-, 16-
// or 32-byte shared load.
template <int N>
__device__ __forceinline__ void load_words(const unsigned char* p, uint32_t (&w)[N]) {
  if constexpr (N == 2) {
    const uint2 v = *reinterpret_cast<const uint2*>(p);
    w[0] = v.x, w[1] = v.y;
  } else {
#pragma unroll
    for (int i = 0; i < N / 4; ++i) {
      const uint4 v = reinterpret_cast<const uint4*>(p)[i];
      w[4 * i] = v.x, w[4 * i + 1] = v.y, w[4 * i + 2] = v.z, w[4 * i + 3] = v.w;
    }
  }
}

// K: the taps held in registers per axis on the staged paths (the plan's
// kr and kc, padded with zero weights on the last real tap: each adds +0
// to a sum of non-negative terms, which changes no bit).
template <typename S, int K>
__global__ void __launch_bounds__(kThreads, T360_AREA_MIN_BLOCKS)
    area_kernel(const __grid_constant__ CUtensorMap map, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages];
  // TMA writes 128-byte aligned stages; offsetting the array itself (no
  // integer round trip) keeps its accesses shared-memory loads
  unsigned char* const ring = smem_raw + ((0u - smem_u32(smem_raw)) & 127u);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // coop: every thread stages each item, between two CTA barriers, in two
  // stages taken in turn (a plane whose rows are not 16-byte aligned)
  const bool coop = a.copy == kScalar;
  const bool words = (a.W * sizeof(S)) % 4 == 0 && reinterpret_cast<uintptr_t>(a.src) % 4 == 0;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], a.copy == kTma ? 1 : 32);
      mbar_init(&empty[s], kWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == kWarps && !coop) {
    produce<S>(&map, a, ring, full, empty);
    return;
  }

  const size_t plane = static_cast<size_t>(a.H) * a.W;
  const size_t oplane = static_cast<size_t>(a.OH) * a.OW;
  const S* const src = static_cast<const S*>(a.src);
  constexpr int kPer = 4 / sizeof(S);     // samples per 32-bit word
  constexpr int kWords = K * sizeof(S);  // a packed row: 4 K samples
  // this thread's taps for the current tile: its row's, and on the
  // per-column path its 4 columns' (lane + 32 j), as stage offsets; on the
  // packed path coff[0][0] is its 4 outputs' first sample and cw[0][0]
  // the tile's one column weight
  int roff[K], coff[4][K];
  float rw[K], cw[4][K];
  int s = 0, cur = -1;
  unsigned phase = 0;
  int r = 0, c0 = 0, nc = 0, mode = kDirect;
  bool row_in = false;
  S* out_row = nullptr;  // this thread's output row of the tile in frame 0
  for (Item it(a); it.left > 0; it.next(a)) {
    const int tile = it.tile, f = it.f;
    if (tile != cur) {
      const int* tl = a.tiles + tile * 8;
      const int r0 = __ldg(tl), nr = __ldg(tl + 2), y0 = __ldg(tl + 4), x0 = __ldg(tl + 5);
      c0 = __ldg(tl + 1), nc = __ldg(tl + 3), mode = __ldg(tl + 7);
      if (mode == kPacked && !a.packed) mode = kStaged;
      row_in = warp < nr;
      r = r0 + min(warp, nr - 1);
      out_row = static_cast<S*>(a.dst) + static_cast<size_t>(r) * a.OW + c0;
      cur = tile;
      if (mode != kDirect) {
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const int p = min(k, a.kr - 1);
          roff[k] = stage_offset(a, min(__ldg(a.row_first + r) + p, a.H - 1) - y0, 0);
          rw[k] = k < a.kr ? __ldg(a.row_w + r * a.kr + p) : 0.0f;
        }
      }
      if (mode == kPacked) {
        coff[0][0] = stage_offset(a, 0, __ldg(a.col_first + c0) - x0 + 4 * K * lane);
        cw[0][0] = __ldg(a.col_w + c0 * a.kc);
      } else if (mode == kStaged) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = c0 + min(lane + 32 * j, nc - 1);
#pragma unroll
          for (int k = 0; k < K; ++k) {
            const int q = min(k, a.kc - 1);
            coff[j][k] = stage_offset(a, 0, min(__ldg(a.col_first + c) + q, a.W - 1) - x0);
            cw[j][k] = k < a.kc ? __ldg(a.col_w + c * a.kc + q) : 0.0f;
          }
        }
      }
    }
    S* const dst = out_row + f * oplane;
    if (mode == kDirect) {  // taps read from device memory
      if (row_in)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (lane + 32 * j < nc)
            dst[lane + 32 * j] =
                static_cast<S>(round_bits(sum_global<S>(src + f * plane, a, r, c0 + lane + 32 * j),
                                          a.maxval));
      continue;
    }

    unsigned char* const buf = ring + s * a.stage_bytes;
    if (coop) {  // the previous barrier freed this stage: its item was two ago
      const int* tl = a.tiles + tile * 8;
      const int y0 = __ldg(tl + 4), x0 = __ldg(tl + 5);
      stage_all<S>(a, buf, src + f * plane + static_cast<size_t>(y0) * a.W + x0, __ldg(tl + 6),
                   x0, words);
      __syncthreads();
    } else {
      mbar_wait(&full[s], phase);  // this item's span has landed
    }
    if (row_in && mode == kPacked) {
      if (4 * lane < nc) {  // nc is a multiple of 4 on a packed tile
        // h[i]: the row pass at the lane's sample i; output j sums h[K j + q]
        float h[4 * K];
#pragma unroll
        for (int p = 0; p < K; ++p) {
          uint32_t w[kWords];
          load_words(buf + (roff[p] + coff[0][0]) * sizeof(S), w);
#pragma unroll
          for (int i = 0; i < 4 * K; ++i) {
            const float term = __fmul_rn(t360::sample_to_float<S>(w[i / kPer], i % kPer), rw[p]);
            h[i] = p == 0 ? term : __fadd_rn(h[i], term);
          }
        }
        uint32_t v[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          float sum = __fmul_rn(h[K * j], cw[0][0]);
#pragma unroll
          for (int q = 1; q < K; ++q) sum = __fadd_rn(sum, __fmul_rn(h[K * j + q], cw[0][0]));
          v[j] = round_bits(sum, a.maxval);
        }
        if constexpr (sizeof(S) == 1) {
          *reinterpret_cast<uint32_t*>(dst + 4 * lane) = __byte_perm(
              __byte_perm(v[0], v[1], 0x0040), __byte_perm(v[2], v[3], 0x0040), 0x5410);
        } else {
          *reinterpret_cast<uint2*>(dst + 4 * lane) =
              make_uint2(__byte_perm(v[0], v[1], 0x5410), __byte_perm(v[2], v[3], 0x5410));
        }
      }
    } else if (row_in) {
      const S* sbuf = reinterpret_cast<const S*>(buf);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float sum = 0.0f;
#pragma unroll
        for (int q = 0; q < K; ++q) {
          const S* col = sbuf + coff[j][q];
          float h = 0.0f;
#pragma unroll
          for (int p = 0; p < K; ++p) {
            const float term = __fmul_rn(sample_float(col[roff[p]]), rw[p]);
            h = p == 0 ? term : __fadd_rn(h, term);
          }
          const float term = __fmul_rn(h, cw[j][q]);
          sum = q == 0 ? term : __fadd_rn(sum, term);
        }
        if (lane + 32 * j < nc) dst[lane + 32 * j] = static_cast<S>(round_bits(sum, a.maxval));
      }
    }
    if (!coop) {
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
    }
    if (++s == (coop ? 2 : a.stages)) s = 0, phase ^= 1;
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

// A ring of `stages` stages and the 128 bytes that align it.
int smem_for(int stage_bytes, int stages) {
  return stage_bytes > 0 ? stages * stage_bytes + 128 : 0;
}

}  // namespace

// The arguments of a launch of K4 (t360_area) and of a graph node's update
// (t360_area_update), as ops/area.py's AreaCall lays them out.
struct AreaCall {
  const void* src;
  void* dst;
  int sample_bytes, maxval, B, H, W, OH, OW;
  const int* row_first;
  const float* row_w;
  int kr;
  const int* col_first;
  const float* col_w;
  int kc, taps;
  const int* tiles;
  int n_tiles, box_w, box_h, nbox, stages, copy, packed, ctas, order;
};

namespace {

// Checks a launch of K4, encodes its tensor map from src and builds its
// Args, then returns f(kernel, grid, shared memory, kernel arguments): a
// launch and a graph node's update take theirs from here alike.
template <typename F>
int with_launch(F&& f, const AreaCall& c) {
  const auto& [src, dst, sample_bytes, maxval, B, H, W, OH, OW, row_first, row_w, kr, col_first,
               col_w, kc, taps, tiles, n_tiles, box_w, box_h, nbox, stages, copy, packed, ctas,
               order] = c;
  const void* k = kernel_for(sample_bytes, taps);
  const bool staged = box_w > 0;
  const int stage_bytes = (box_w * box_h * nbox * sample_bytes + 127) / 128 * 128;
  const int smem = smem_for(stage_bytes, stages);
  if (k == nullptr || B <= 0 || H <= 0 || W <= 0 || OH <= 0 || OW <= 0 || kr <= 0 ||
      kc <= 0 || (staged && (kr > taps || kc > taps)) || n_tiles <= 0 || ctas <= 0 ||
      static_cast<long long>(n_tiles) * B > 0x7fffffffLL || ctas > n_tiles * B ||
      stages < 2 || stages > kMaxStages || copy < kTma || copy > kScalar ||
      (staged && (box_w % 16 != 0 || box_w > 256 || box_h <= 0 || box_h > 256 || nbox <= 0)) ||
      smem > 227 * 1024 ||
      (staged && copy != kScalar &&
       ((static_cast<long long>(W) * sample_bytes) % 16 != 0 ||
        reinterpret_cast<uintptr_t>(src) % 16 != 0)) ||
      (sample_bytes == 1 ? maxval != 255 : !(maxval >= 255 && maxval <= 65535)) ||
      order < 0 || order > 1)
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map = {};
  if (staged && copy == kTma) {
    const t360::EncodeTiled encode = t360::encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(W), static_cast<cuuint64_t>(H),
                                static_cast<cuuint64_t>(B)};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(W) * sample_bytes,
                                   static_cast<cuuint64_t>(H) * W * sample_bytes};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_w), static_cast<cuuint32_t>(box_h), 1};
    const cuuint32_t elem[3] = {1, 1, 1};
    const CUresult r = encode(
        &map, sample_bytes == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_UINT16,
        3, const_cast<void*>(src), dims, strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
        CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
    if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  }
  Args a{src,     dst,   tiles, row_first, row_w,       col_first, col_w, B,    H,
         W,       OH,    OW,    kr,        kc,          n_tiles,   box_w, box_h, nbox,
         stage_bytes, stages, copy, packed, order, static_cast<unsigned>(maxval)};
  void* args[] = {&map, &a};
  return f(k, dim3(ctas), smem, args);
}

}  // namespace

// One launch of K4 on stream, with c's fields: src [B, H, W] and dst
// [B, OH, OW], samples of sample_bytes each (1: uint8; 2: uint16, rounded
// and saturated to maxval, the depth's largest sample); row_first int32
// [OH], row_w float32 [OH, kr]; col_first int32 [OW], col_w float32 [OW,
// kc]; tiles int32 [n, 8] (r0, c0, rows, cols,
// y0, x0, span rows, mode: 0 direct, 1 staged, 2 staged with packed
// taps).  taps: 2 or 4, at least kr and kc if any tile is staged.  A stage
// holds nbox boxes of box_h rows of box_w samples (box_w a multiple of 16
// and at most 256, box_h at most 256; 0 0 0 if no tile is staged); the
// ring has `stages` of them (2 to 8).  copy: 0, TMA (src and its rows
// 16-byte aligned); 1, 16-byte cp.async by the producer warp (the same
// alignment); 2, every thread with plain loads, two stages in turn.
// packed: 0 takes the per-column path on packed tiles too.  ctas: the
// grid.  order: how a CTA walks the n_tiles x B (tile, frame) items (0: a
// contiguous run; 1: every ctas-th tile; see Item).  Returns 0, a
// cudaError_t, or -CUresult if the tensor map cannot be encoded.  node: see
// t360::captured_node (null: not asked for).
extern "C" int t360_area(const AreaCall* c, void* stream, void** node) {
  return with_launch(
      [&](const void* k, dim3 grid, int smem, void** args) {
        return t360::launch(k, grid, dim3(kThreads), smem, args,
                            static_cast<cudaStream_t>(stream), node);
      },
      *c);
}

// Re-points kernel node `node` of the instantiated graph `exec`, captured
// from a t360_area launch, to the arguments c (t360::update_node): checked
// and built as t360_area's, its tensor map encoded anew.  Returns as
// t360_area does.
extern "C" int t360_area_update(void* exec, void* node, const AreaCall* c) {
  return with_launch(
      [&](const void* k, dim3 grid, int smem, void** args) {
        return t360::update_node(exec, node, k, grid, dim3(kThreads), smem, args);
      },
      *c);
}

// One instantiation's registers, local memory bytes (spills and stack),
// resident CTAs per SM and dynamic shared memory for a launch with a ring
// of `stages` stages of stage_bytes: out[0..3].
extern "C" int t360_area_attrs(int sample_bytes, int taps, int stage_bytes, int stages,
                               int* out) {
  const void* k = kernel_for(sample_bytes, taps);
  if (k == nullptr || stage_bytes < 0 || stages < 2 || stages > kMaxStages)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, k);
  const int smem = smem_for(stage_bytes, stages);
  if (e == cudaSuccess) e = t360::allow_smem(k, smem);
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
