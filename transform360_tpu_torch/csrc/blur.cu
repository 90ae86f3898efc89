// K1: the adaptive low-pass prefilter, with the half-up round, in one
// pass through shared memory, for uint8 planes and for uint16 planes (the
// 10-, 12- and 16-bit formats, saturated at the depth's maximum).
//
// Replaces the Pallas kernel transform360_tpu/ops/blur_lane.py:269
// (_make_kernel, entry blur_lane).  It computes what
// transform360_tpu.filtering.apply_blur followed by pipeline._round_u8
// computes, and what transform360_tpu_torch.filtering.blur_plain + round
// computes, bit for bit; its uint16 instantiations compute what apply_blur
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
// (4 at uint16), but the work is (2*rx+1) + (2*ry+1) products and 2*rx +
// 2*ry sums per pixel, each its own FMUL or FADD (no FMA may fuse them),
// plus the samples' conversions to float and the round.  At the flagship
// (rx 1, 2, 6 by latitude, ry 1) that is some 20 float instructions per
// pixel for the taps alone, so instruction issue, not bytes, bounds K1
// (chip_smoke.py counts the row loop's SASS per pixel and prints the issue
// bound): every instruction per pixel counts.  The design:
//   * Persistent CTAs.  The grid is the CTAs resident on the card at once;
//     CTA i walks the items i, i + P, i + 2P, ... of the tile-major list of
//     (tile, frame, part) items (ops/blur.py: work_list), so that every CTA
//     takes a share of every band's taps and one CTA's loads overlap its
//     previous item's compute at any batch size.  A part is an even share
//     of a tile's rows: the launch cuts tiles into parts where the batch is
//     too small to give every CTA many items.
//   * Tiles (ops/blur.py: BlurTables) never cross a band, a segment or an
//     eye, so a tile has one tap set; they are as wide as the CTA's consumer
//     warps side by side (32 threads of V adjacent columns: 1024 columns at
//     uint8, 768 at uint16; V is 8, or at uint8 16 where the batch gives
//     every CTA a tile-frame: 2 warps of 16 columns issue fewer
//     instructions per pixel, 4 warps of 8 finish a small batch sooner)
//     and up to 144 rows tall, and each thread walks every row of its
//     item's part, so only 2*RY halo rows per part take an x pass that is
//     not an output row's.  Zero tiles (set -1) write the leftover row or
//     column of odd stereo dims.
//   * One producer warp fills a ring of shared-memory stages, each a slab
//     of `slab` consecutive source rows of an item (a row: `row_bytes` of
//     the plane from sample x0, 16-byte aligned as TMA requires of a box's
//     start, `pitch` bytes apart).  On a plane whose rows are whole 16-byte
//     chunks, each row is one TMA box (cp.async.bulk.tensor.3d of a
//     CUtensorMap of 8-byte elements encoded per launch and passed as a
//     kernel parameter) issued by one lane at its row index clamped into
//     the plane, completing on the stage's `full` mbarrier.  TMA fills
//     columns outside the plane with zeros; on tiles that read them the
//     producer waits for the rows, copies the edge sample over them and
//     only then marks the stage full.  Any other plane (rows not whole
//     16-byte chunks, or narrower than a staged row) is copied by the
//     producer's lanes with clamped loads.  The consumer warps never stage,
//     divide or meet at a CTA barrier: each waits on `full`, reads, and
//     arrives on the stage's `empty` mbarrier.
//   * Fewer instructions per pixel.  Per source row a thread reads its V +
//     2*rx samples in aligned 16-byte loads (at V 16, its window's offset
//     in its chunk is a constant of rx) or funnel-shifted words (V 8),
//     turns each into a float with two full-rate instructions (PRMT into
//     0x4B0000bb, then a subtract of 2^23), and runs the x pass of its V
//     columns: the wider V, the fewer conversions and per-row instructions
//     per pixel, and the more mirrored products it shares.  The plan's taps
//     are Gaussian -- symmetric and non-negative, which the host checks bit
//     for bit -- so k[u] * p and k[2rx - u] * p are one product, computed
//     once (the compiler sees the same operands), and the y pass shares
//     q[0] * h and q[2ry] * h.  The y pass keeps 2*RY partial sums per
//     column that rotate with the row, the row loop unrolled by 2*RY, so no
//     register moves; each output row's sum still adds its terms in
//     ascending t.  The round adds 0.5, then 2^23 rounding down, so the
//     float's low bits hold floor(s + 0.5) (no F2I; no clamp at 0, as a sum
//     of non-negative terms is >= +0); one integer min saturates it and
//     PRMTs pack the outputs into one 16-byte store.
//   * Sources.  A launch reads its batch where it lies, from up to two
//     sources (the U and V planes of a chroma batch; ops/sources.py): each
//     has its own base, frame stride and tensor map, and an item's frame
//     picks its source once, in the producer; the consumers write one
//     stacked output and never see which source a slab came from.
// A plan's y radius is padded up to the ring's RY (1 or 3) with zero taps,
// which changes no bit (0 * h = +0, and adding +0 leaves a sum as it is).
// Plans with a larger y radius, taps that are not Gaussian, or rows too
// wide for one TMA box take blur_direct_kernel: the same tiles, one thread
// per pixel, every tap read through L1.  Either way it is one launch per
// call, with no scratch and no chunking of the batch.

#include "common.cuh"

namespace {

using t360::mbar_arrive;
using t360::mbar_expect_tx;
using t360::mbar_init;
using t360::mbar_wait;
using t360::sample_to_float;

// The register of tap u of 2 R + 1 symmetric taps: k[u] and k[2 R - u]
// are one register, so their products with one sample are one product.
template <int R>
__device__ __forceinline__ constexpr int tap(int u) {
  return u > R ? 2 * R - u : u;
}
constexpr int kMaxStages = 8;
constexpr int kDirectThreads = 256;

// A tile's columns (ops/blur.py: tile_width): a staged row of a tile and
// its halo must fit one TMA box of 256 8-byte elements.
template <typename S>
constexpr int kTW = sizeof(S) == 1 ? 1024 : 768;
// Samples in 16 bytes: staged rows start 16-byte aligned, and a thread's
// first column too when V is a multiple of it, so the offset of its
// window in its 16-byte chunk is (-rx) mod kE<S>, a constant.
template <typename S>
constexpr int kE = 16 / static_cast<int>(sizeof(S));
// Consumer warps of a CTA of threads of V adjacent columns (a row's
// outputs in one 8- or 16-byte store), side by side across a tile's
// columns, and the producer warp.
template <typename S, int V>
constexpr int kWarps = kTW<S> / (32 * V);
template <typename S, int V>
constexpr int kThreads = 32 * (kWarps<S, V> + 1);
template <typename S>
constexpr int kPer = 4 / static_cast<int>(sizeof(S));  // samples per 32-bit word
// Resident CTAs per SM the registers must allow: 4 at y radius 1; y
// radius 3 keeps 6 partial sums per column, which fit the registers of 2
// CTAs only.
template <int RY>
constexpr int kMinBlocks = RY == 1 ? 4 : 2;

enum Copy { kTma = 0, kWarp = 1 };  // how a stage is filled

// n / d as (n * m) >> k, exact for 0 <= n < 2^31: m = ceil(2^k / d) with
// k = 32 + ceil(log2 d) errs by e = m d - 2^k < d <= 2^(k-32), and
// n e < 2^k.  The ring kernel divides by no other means: a division by a
// runtime divisor goes through the conversion unit (I2F, F2I).
struct Div {
  unsigned long long m;
  int k;
};
Div make_div(unsigned d) {
  int l = 0;
  while ((1ull << l) < d) ++l;
  return {((1ull << (32 + l)) + d - 1) / d, 32 + l};
}
__device__ __forceinline__ int quot(int n, const Div& d) {
  return static_cast<int>((static_cast<unsigned long long>(n) * d.m) >> d.k);
}

struct Args {
  // The logical batch of B frames is read from two sources where they lie
  // (ops/sources.py): frames [0, b0) are source 0's, the rest source 1's
  // (U and V of a chroma batch, never stacked by a copy).  Each source's
  // rows are packed; fs0 and fs1 are its frame strides in samples.
  const void* src0;
  const void* src1;
  long long fs0, fs1;
  int b0;
  void* dst;           // [B, H, W], stacked
  const int* tiles;    // [n, 6]: r0, c0, rows, cols, set (-1: zeros), x0
  const float* kx;     // [sets, lx] centred x taps
  const int* rx;       // [sets]
  const float* ky;     // [sets, ly] centred y taps (ring: ly = 2 RY + 1)
  const int* ry;       // [sets] (direct kernel)
  int lx, ly;
  int B, H, W, n_tiles, parts;
  int row_bytes;  // bytes of a staged row, from sample x0 (a multiple of 16)
  int pitch;      // bytes between staged rows (a multiple of 128)
  int slab;       // staged rows per stage (a multiple of 2 RY)
  int stages;     // the ring's depth
  int copy;       // Copy
  int vec_out;    // dst and W allow 16-byte vector stores
  unsigned maxval;
  Div per_tile, per_part, per_row;  // by B * parts, parts, and a staged row's samples
};

// Item j of the tile-major list of (tile, frame, part) items, and the rows
// [p0, p1) of its part: an even share of the tile's rows.
struct Item {
  int tile, f, p0, p1;
  __device__ Item(const Args& a, int j) {
    tile = quot(j, a.per_tile);
    const int r = j - tile * a.B * a.parts;
    f = quot(r, a.per_part);
    const int part = r - f * a.parts;
    const int* t = a.tiles + 6 * tile;
    const int r0 = __ldg(t), nr = __ldg(t + 2);
    p0 = r0 + quot(part * nr, a.per_part);
    p1 = r0 + quot((part + 1) * nr, a.per_part);
  }
};

__device__ __forceinline__ int n_items(const Args& a) { return a.n_tiles * a.B * a.parts; }

// Frame f of the logical batch, in its source.
template <typename S>
__device__ __forceinline__ const S* frame_src(const Args& a, int f) {
  return f < a.b0 ? static_cast<const S*>(a.src0) + f * a.fs0
                  : static_cast<const S*>(a.src1) + (f - a.b0) * a.fs1;
}

// Copies the edge samples of a staged row over the columns TMA filled
// with zeros: columns [x0, 0) take column 0's sample, columns [W, hi) the
// sample of column W - 1 (hi: the last column a tap of the tile reads,
// plus one).
template <typename S>
__device__ __forceinline__ void clamp_row(S* row, int x0, int W, int hi, int n) {
  for (int c = x0; c < min(0, x0 + n); ++c) row[c - x0] = row[-x0];
  for (int c = max(W, x0); c < min(hi, x0 + n); ++c) row[c - x0] = row[W - 1 - x0];
}

// The producer warp: fills a stage for each slab of each staged item of
// its CTA, in order, waiting for the stage's consumers `stages` slabs
// before.  An item's frame picks its source (map0 or map1) once.
template <typename S, int RY>
__device__ __forceinline__ void produce(const CUtensorMap* map0, const CUtensorMap* map1,
                                        const Args& a, unsigned char* ring, uint64_t* full,
                                        uint64_t* empty, uint64_t* aux) {
  const int lane = threadIdx.x & 31;
  const int stage_bytes = a.slab * a.pitch;
  const int row_n = a.row_bytes / static_cast<int>(sizeof(S));
  int s = 0;
  unsigned phase = 0, aux_phase = 0;
  for (int j = blockIdx.x; j < n_items(a); j += gridDim.x) {
    const Item it(a, j);
    const int* t = a.tiles + 6 * it.tile;
    const int set = __ldg(t + 4);
    if (set < 0 || it.p1 == it.p0) continue;
    const int c0 = __ldg(t + 1), nc = __ldg(t + 3), x0 = __ldg(t + 5);
    const int hi = c0 + nc + __ldg(a.rx + set);  // past the last column a tap reads
    const bool edge = x0 < 0 || hi > a.W;
    const int y0 = it.p0 - RY, n = it.p1 - it.p0 + 2 * RY;
    const bool second = it.f >= a.b0;
    const CUtensorMap* map = second ? map1 : map0;
    const int fz = second ? it.f - a.b0 : it.f;  // the frame in its source
    const S* src = frame_src<S>(a, it.f);
    for (int k = 0; k < n; k += a.slab) {
      mbar_wait(&empty[s], phase ^ 1);  // its consumers of `stages` slabs before are done
      unsigned char* buf = ring + s * stage_bytes;
      if (a.copy == kTma) {
        uint64_t* bar = edge ? &aux[s] : &full[s];
        if (lane == 0) mbar_expect_tx(bar, a.slab * a.row_bytes);
        __syncwarp();
        for (int i = lane; i < a.slab; i += 32)
          t360::tma_load(buf + i * a.pitch, map, bar,
                         x0 * static_cast<int>(sizeof(S)) / 8,
                         t360::clamp_idx(y0 + k + i, a.H), fz);
        if (edge) {  // rows landed: clamp their columns, then hand them over
          mbar_wait(bar, (aux_phase >> s) & 1u);
          aux_phase ^= 1u << s;
          for (int i = lane; i < a.slab; i += 32)
            clamp_row(reinterpret_cast<S*>(buf + i * a.pitch), x0, a.W, hi, row_n);
          t360::fence_proxy_async();  // before TMA writes this stage again
          __syncwarp();
          if (lane == 0) mbar_arrive(&full[s]);
        }
      } else {  // samples by clamped loads: any alignment
        for (int e = lane; e < a.slab * row_n; e += 32) {
          const int i = quot(e, a.per_row), c = e - i * row_n;
          reinterpret_cast<S*>(buf + i * a.pitch)[c] =
              src[static_cast<size_t>(t360::clamp_idx(y0 + k + i, a.H)) * a.W +
                  t360::clamp_idx(x0 + c, a.W)];
        }
        __syncwarp();
        if (lane == 0) mbar_arrive(&full[s]);
      }
      if (++s == a.stages) s = 0, phase ^= 1;
    }
  }
}

// This thread's place in an item: its columns and where it reads them.
struct Cols {
  int col;        // first of its V output columns
  int b;          // its first tap's sample in a staged row
  unsigned sh;    // that sample's bit offset in its 32-bit word
  int wo;         // that word
  int chunk;      // the 16-byte chunk that holds it
  bool on;        // its warp has a column inside the tile
  bool whole;     // all its columns inside the tile, and vector stores allowed
  bool some;      // some of them inside the tile
  int lo, hi;     // the tile's columns [lo, hi)
};

// The x pass of V adjacent columns from one staged row, read at the
// thread's window (cl): h[c] = sum_u k[u] * x[c + u], u ascending; taps
// are symmetric, so kr holds k[0 .. RX] and k[u] is kr[tap<RX>(u)].
template <typename S, int RX, int V>
__device__ __forceinline__ void x_row(const unsigned char* row, const Cols& cl, const float* kr,
                                      float (&h)[V]) {
  constexpr int P = kPer<S>;
  constexpr int N = V + 2 * RX;  // samples read
  float p[N];
  if constexpr (V % kE<S> == 0) {  // aligned 16-byte loads; each sample's word and byte known
    constexpr int OFF = (kE<S> - RX % kE<S>) % kE<S>;  // the window's start in its chunk
    constexpr int NC = (OFF + N + kE<S> - 1) / kE<S>;
    uint32_t a[4 * NC];
    const uint4* c = reinterpret_cast<const uint4*>(row) + cl.chunk;
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      const uint4 v = c[i];
      a[4 * i] = v.x, a[4 * i + 1] = v.y, a[4 * i + 2] = v.z, a[4 * i + 3] = v.w;
    }
#pragma unroll
    for (int i = 0; i < N; ++i) p[i] = sample_to_float<S>(a[(OFF + i) / P], (OFF + i) % P);
  } else {  // 32-bit loads from the window's word, aligned by funnel shifts
    constexpr int NQ = (N + P - 1) / P;
    const uint32_t* w = reinterpret_cast<const uint32_t*>(row) + cl.wo;
    uint32_t a[NQ + 1];
#pragma unroll
    for (int i = 0; i <= NQ; ++i) a[i] = w[i];
#pragma unroll
    for (int i = 0; i < N; ++i)
      p[i] = sample_to_float<S>(__funnelshift_r(a[i / P], a[i / P + 1], cl.sh), i % P);
  }
#pragma unroll
  for (int c = 0; c < V; ++c) {
    float acc = __fmul_rn(kr[0], p[c]);
#pragma unroll
    for (int u = 1; u <= 2 * RX; ++u)
      acc = __fadd_rn(acc, __fmul_rn(kr[tap<RX>(u)], p[c + u]));
    h[c] = acc;
  }
}

// The same for any radius: a window of V samples slides over the taps,
// read sample by sample from row (the first tap's sample).
template <typename S, int V>
__device__ __forceinline__ void x_row_any(const S* row, const float* __restrict__ k, int rx,
                                          float (&h)[V]) {
  float p[V];
#pragma unroll
  for (int c = 0; c < V; ++c) {
    p[c] = sample_to_float<S>(row[c], 0);
    h[c] = __fmul_rn(k[0], p[c]);
  }
  for (int u = 1; u <= 2 * rx; ++u) {
#pragma unroll
    for (int c = 0; c < V - 1; ++c) p[c] = p[c + 1];
    p[V - 1] = sample_to_float<S>(row[u + V - 1], 0);
    const float ku = __ldg(k + u);
#pragma unroll
    for (int c = 0; c < V; ++c) h[c] = __fadd_rn(h[c], __fmul_rn(ku, p[c]));
  }
}

// One source row's y pass, at slot J of the rotation: the partial sums
// acc[(o mod 2 RY)] of the output rows o = i - 2 RY + 1 .. i - 1 take
// their term, output row i - 2 RY (slot J) completes into done, and
// output row i starts in slot J.  q holds ky[tap<RY>(t)].
template <int RY, int J, int V>
__device__ __forceinline__ void y_step(float (&acc)[2 * RY][V], const float (&h)[V],
                                       const float* q, float (&done)[V]) {
#pragma unroll
  for (int c = 0; c < V; ++c) {
    done[c] = __fadd_rn(acc[J][c], __fmul_rn(q[tap<RY>(2 * RY)], h[c]));
#pragma unroll
    for (int t = 1; t < 2 * RY; ++t) {
      float& a = acc[(J - t + 2 * RY) % (2 * RY)][c];
      a = __fadd_rn(a, __fmul_rn(q[tap<RY>(t)], h[c]));
    }
    acc[J][c] = __fmul_rn(q[0], h[c]);
  }
}

// floor(s + 0.5) in the low bits of the result, saturated at maxval, for
// s >= +0 (a sum of products of non-negative taps and samples): 2^23
// added rounding down leaves floor(t) there, for t < 2^23.
__device__ __forceinline__ uint32_t round_low(float s, uint32_t top) {
  return min(__float_as_uint(__fadd_rd(__fadd_rn(s, 0.5f), 8388608.0f)), top);
}

// A thread's outputs of one row in 16-byte stores: 16 (or 8) uint8
// samples packed from the low bytes, or 8 uint16 from the low halves.
__device__ __forceinline__ uint32_t pack4(const uint32_t* v) {
  return __byte_perm(__byte_perm(v[0], v[1], 0x0040), __byte_perm(v[2], v[3], 0x0040), 0x5410);
}
template <int V>
__device__ __forceinline__ void store_row(uint8_t* d, const uint32_t (&v)[V]) {
  if constexpr (V == 16) {
    *reinterpret_cast<uint4*>(d) = make_uint4(pack4(v), pack4(v + 4), pack4(v + 8), pack4(v + 12));
  } else {
    *reinterpret_cast<uint2*>(d) = make_uint2(pack4(v), pack4(v + 4));
  }
}
template <int V>
__device__ __forceinline__ void store_row(uint16_t* d, const uint32_t (&v)[V]) {
  static_assert(V == 8, "8 uint16 samples a store");
  *reinterpret_cast<uint4*>(d) =
      make_uint4(__byte_perm(v[0], v[1], 0x5410), __byte_perm(v[2], v[3], 0x5410),
                 __byte_perm(v[4], v[5], 0x5410), __byte_perm(v[6], v[7], 0x5410));
}


// What an item's row loop reads, beside the partial sums.
template <typename S>
struct Rows {
  const unsigned char* buf;  // the stage
  const float* kr;           // x taps k[0 .. RX] in registers (RX >= 0)
  const float* k;            // the tile's taps in memory (any radius)
  const float* qr;           // y taps q[0 .. RY] in registers
  S* out;                    // the frame's output plane
  int rx, pitch, first;      // x radius; staged row pitch; the part's first row
  uint32_t top;              // 0x4B000000 | maxval
};

// Source rows r + J .. r + 2 RY - 1 of a slab of m rows (slot J of the
// rotation onward); row r + J completes output row o0 + J.  A recursion
// rather than a loop, so that J is a constant and the partial sums stay in
// registers.
template <typename S, int RX, int RY, int V, int J>
__device__ __forceinline__ void rows_from(const Rows<S>& w, const Args& a, const Cols& cl, int r,
                                          int m, int o0, float (&acc)[2 * RY][V]) {
  if constexpr (J < 2 * RY) {
    if (J > 0 && r + J >= m) return;
    float h[V];
    if constexpr (RX >= 0) {
      x_row<S, (RX >= 0 ? RX : 0), V>(w.buf + (r + J) * w.pitch, cl, w.kr, h);
    } else {
      x_row_any<S, V>(reinterpret_cast<const S*>(w.buf + (r + J) * w.pitch) + cl.b, w.k, w.rx,
                      h);
    }
    float done[V];
    y_step<RY, J, V>(acc, h, w.qr, done);
    const int o = o0 + J;
    if (o >= w.first) {
      uint32_t v[V];
#pragma unroll
      for (int c = 0; c < V; ++c) v[c] = round_low(done[c], w.top);
      S* d = w.out + static_cast<size_t>(o) * a.W + cl.col;
      if (cl.whole) {
        store_row<V>(d, v);
      } else if (cl.some) {
#pragma unroll
        for (int c = 0; c < V; ++c)
          if (cl.col + c >= cl.lo && cl.col + c < cl.hi) d[c] = static_cast<S>(v[c]);
      }
    }
    rows_from<S, RX, RY, V, J + 1>(w, a, cl, r, m, o0, acc);
  }
}

// One item: the x pass of every source row of its part, through the ring,
// and the y pass, round and store of every output row.  RX < 0: any x
// radius (rx).  Returns with s and phase past the item's slabs.
template <typename S, int RX, int RY, int V>
__device__ __forceinline__ void consume(const Args& a, const Item& it, const Cols& cl, int rx,
                                        const float* __restrict__ k, const float* __restrict__ q,
                                        const unsigned char* ring, uint64_t* full,
                                        uint64_t* empty, int& s, unsigned& phase) {
  constexpr int PERIOD = 2 * RY;
  const int lane = threadIdx.x & 31;
  constexpr int NK = RX >= 0 ? RX + 1 : 1;
  float kr[NK];
#pragma unroll
  for (int u = 0; u < NK; ++u) kr[u] = __ldg(k + u);
  float qr[RY + 1];
#pragma unroll
  for (int t = 0; t <= RY; ++t) qr[t] = __ldg(q + t);
  Rows<S> w{nullptr, kr, k, qr,
            static_cast<S*>(a.dst) + static_cast<size_t>(it.f) * a.H * a.W,
            rx, a.pitch, it.p0, 0x4B000000u | a.maxval};
  const int n = it.p1 - it.p0 + 2 * RY;
  float acc[PERIOD][V] = {};
  for (int k0 = 0; k0 < n; k0 += a.slab) {
    mbar_wait(&full[s], phase);  // this slab's rows have landed
    if (cl.on) {
      w.buf = ring + s * a.slab * a.pitch;
      const int m = min(a.slab, n - k0);
      // slabs start at multiples of PERIOD: row k0 + r + J is at slot J
      for (int r = 0; r < m; r += PERIOD)
        rows_from<S, RX, RY, V, 0>(w, a, cl, r, m, it.p0 + k0 + r - PERIOD, acc);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(&empty[s]);  // this warp is done with the stage
    if (++s == a.stages) s = 0, phase ^= 1;
  }
}

// The ring kernel for y radius RY (1 or 3), Gaussian taps and V columns
// per thread.  The last warp produces; the others consume.
template <typename S, int RY, int V>
__global__ void __launch_bounds__(kThreads<S, V>, kMinBlocks<RY>)
    blur_ring_kernel(const __grid_constant__ CUtensorMap map0,
                     const __grid_constant__ CUtensorMap map1, const Args a) {
  extern __shared__ unsigned char smem_raw[];
  __shared__ __align__(8) uint64_t full[kMaxStages], empty[kMaxStages], aux[kMaxStages];
  // TMA writes 128-byte aligned rows: align the ring itself (no integer
  // round trip of the pointer, which would make its loads generic)
  unsigned char* const ring = smem_raw + ((0u - t360::smem_u32(smem_raw)) & 127u);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < a.stages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kWarps<S, V>);
      mbar_init(&aux[s], 1);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (warp == kWarps<S, V>) {
    produce<S, RY>(&map0, &map1, a, ring, full, empty, aux);
    return;
  }

  const int g = warp * 32 + lane;  // this thread's group of V columns in a tile
  int s = 0;
  unsigned phase = 0;
  for (int j = blockIdx.x; j < n_items(a); j += gridDim.x) {
    const Item it(a, j);
    if (it.p1 == it.p0) continue;
    const int* t = a.tiles + 6 * it.tile;
    const int c0 = __ldg(t + 1), nc = __ldg(t + 3), set = __ldg(t + 4), x0 = __ldg(t + 5);
    Cols cl;
    cl.lo = c0, cl.hi = c0 + nc;
    const int g0 = c0 & ~(V - 1);  // the tile's first group, aligned to V samples
    cl.col = g0 + V * g;
    cl.on = g0 + 32 * V * warp < cl.hi;
    cl.some = cl.col + V > cl.lo && cl.col < cl.hi;
    cl.whole = a.vec_out && cl.col >= cl.lo && cl.col + V <= cl.hi;
    if (set < 0) {  // zeros, and no stage
      if (cl.some) {
        S* out = static_cast<S*>(a.dst) + static_cast<size_t>(it.f) * a.H * a.W;
        for (int r = it.p0; r < it.p1; ++r)
          for (int c = max(cl.col, cl.lo); c < min(cl.col + V, cl.hi); ++c)
            out[static_cast<size_t>(r) * a.W + c] = 0;
      }
      continue;
    }
    const int rx = __ldg(a.rx + set);
    // this thread's first tap's sample, counted from the staged x0
    cl.b = g0 - rx - x0 + V * g;
    cl.wo = cl.b / kPer<S>;
    cl.sh = static_cast<unsigned>(cl.b % kPer<S>) * 8u * sizeof(S);
    cl.chunk = cl.b / kE<S>;
    const float* k = a.kx + static_cast<size_t>(set) * a.lx + (a.lx - 1) / 2 - rx;
    const float* q = a.ky + static_cast<size_t>(set) * a.ly + (a.ly - 1) / 2 - RY;
    switch (rx) {
#define T360_RX(R)                                                                     \
  case R:                                                                              \
    consume<S, R, RY, V>(a, it, cl, rx, k, q, ring, full, empty, s, phase);            \
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
        consume<S, -1, RY, V>(a, it, cl, rx, k, q, ring, full, empty, s, phase);
    }
  }
}

// Any radius and any taps: one thread per output pixel of an item's tile,
// every tap read through L1, in the same order; the CTAs walk the items
// as the ring kernel's do (one part per tile).
template <typename S>
__global__ void __launch_bounds__(kDirectThreads)
    blur_direct_kernel(const __grid_constant__ CUtensorMap, const __grid_constant__ CUtensorMap,
                       const Args a) {
  const size_t plane = static_cast<size_t>(a.H) * a.W;
  for (int j = blockIdx.x; j < n_items(a); j += gridDim.x) {
    const Item it(a, j);
    const int* m = a.tiles + 6 * it.tile;
    const int c0 = __ldg(m + 1), ncols = __ldg(m + 3), set = __ldg(m + 4);
    const int nrows = it.p1 - it.p0;
    const S* frame = frame_src<S>(a, it.f);
    S* out = static_cast<S*>(a.dst) + it.f * plane;
    const int rx = set < 0 ? 0 : __ldg(a.rx + set), ry = set < 0 ? 0 : __ldg(a.ry + set);
    const float* k = a.kx + static_cast<size_t>(max(set, 0)) * a.lx + (a.lx - 1) / 2 - rx;
    const float* q = a.ky + static_cast<size_t>(max(set, 0)) * a.ly + (a.ly - 1) / 2 - ry;
    for (int i = threadIdx.x; i < nrows * ncols; i += kDirectThreads) {
      const int r = it.p0 + i / ncols;
      const int c = c0 + i % ncols;
      S v = 0;
      if (set >= 0) {
        float acc = 0.0f;
        for (int jr = 0; jr <= 2 * ry; ++jr) {
          const S* row = frame + static_cast<size_t>(t360::clamp_idx(r - ry + jr, a.H)) * a.W;
          float h = 0.0f;
          for (int u = 0; u <= 2 * rx; ++u) {
            const float term = __fmul_rn(__ldg(k + u),
                                         static_cast<float>(row[t360::clamp_idx(c + u - rx, a.W)]));
            h = (u == 0) ? term : __fadd_rn(h, term);
          }
          const float term = __fmul_rn(__ldg(q + jr), h);
          acc = (jr == 0) ? term : __fadd_rn(acc, term);
        }
        v = static_cast<S>(t360::round_bits(acc, a.maxval));
      }
      out[static_cast<size_t>(r) * a.W + c] = v;
    }
  }
}

// The instantiations: the direct kernel (ring_ry -1) for either sample
// size; ring kernels at y radius 1 and 3 with 8 columns per thread, and
// for uint8 at y radius 1 with 16 too.
template <typename S, int V>
const void* ring_kernel(int ring_ry) {
  switch (ring_ry) {
    case 1: return reinterpret_cast<const void*>(blur_ring_kernel<S, 1, V>);
    case 3: return reinterpret_cast<const void*>(blur_ring_kernel<S, 3, V>);
    default: return nullptr;
  }
}

const void* kernel_for(int sample_bytes, int ring_ry, int cols) {
  if (sample_bytes != 1 && sample_bytes != 2) return nullptr;
  if (ring_ry == -1)
    return sample_bytes == 1 ? reinterpret_cast<const void*>(blur_direct_kernel<uint8_t>)
                             : reinterpret_cast<const void*>(blur_direct_kernel<uint16_t>);
  if (cols == 8)
    return sample_bytes == 1 ? ring_kernel<uint8_t, 8>(ring_ry) : ring_kernel<uint16_t, 8>(ring_ry);
  if (cols == 16 && sample_bytes == 1 && ring_ry == 1)
    return reinterpret_cast<const void*>(blur_ring_kernel<uint8_t, 1, 16>);
  return nullptr;
}

int threads_for(int sample_bytes, int ring_ry, int cols) {
  if (ring_ry < 0) return kDirectThreads;
  return 32 * ((sample_bytes == 1 ? kTW<uint8_t> : kTW<uint16_t>) / (32 * cols) + 1);
}

// A ring of `stages` stages of `slab` rows `pitch` bytes apart, and the
// 128 bytes that align it.
int smem_for(int ring_ry, int pitch, int slab, int stages) {
  return ring_ry < 0 ? 0 : stages * slab * pitch + 128;
}

// A tensor map of one source, b frames fs samples apart: rows of 8-byte
// elements, so that one box is one staged row.
CUresult encode_source(CUtensorMap* map, t360::EncodeTiled encode, const void* x, long long fs,
                       int b, int sample_bytes, int H, int W, int row_bytes) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(W) * sample_bytes / 8,
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(b)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(W) * sample_bytes,
                                 static_cast<cuuint64_t>(fs) * sample_bytes};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(row_bytes / 8), 1, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT64, 3, const_cast<void*>(x), dims, strides, box,
                elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

bool aligned16(const void* x, long long fs, int sample_bytes) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 && (fs * sample_bytes) % 16 == 0;
}

}  // namespace

// The arguments of a launch of K1 (t360_blur) and of a graph node's
// update (t360_blur_update), as ops/blur.py's BlurCall lays them out.
struct BlurCall {
  const void* x0;
  long long fs0;
  int b0;
  const void* x1;
  long long fs1;
  void* out;
  int sample_bytes, maxval, B, H, W;
  const int* tiles;
  int n_tiles;
  const float* kx;
  const int* rx;
  int lx;
  const float* ky;
  const int* ry;
  int ly;
  int ring_ry, cols, row_bytes, pitch, slab, stages, parts, copy, ctas, vec_out;
};

namespace {

// Checks a launch of K1, encodes its tensor maps from the sources'
// pointers and builds its Args, then returns f(kernel, grid, block, shared
// memory, kernel arguments): a launch and a graph node's update take
// theirs from here alike.
template <typename F>
int with_launch(F&& f, const BlurCall& c) {
  const auto& [x0, fs0, b0, x1, fs1, out, sample_bytes, maxval, B, H, W, tiles, n_tiles, kx, rx,
               lx, ky, ry, ly, ring_ry, cols, row_bytes, pitch, slab, stages, parts, copy, ctas,
               vec_out] = c;
  const void* k = kernel_for(sample_bytes, ring_ry, cols);
  const bool ring = ring_ry > 0;
  const long long items = static_cast<long long>(n_tiles) * B * parts;
  const int smem = smem_for(ring_ry, pitch, slab, stages);
  const long long plane = static_cast<long long>(H) * W;
  if (k == nullptr || B <= 0 || H <= 0 || W <= 0 || n_tiles <= 0 || parts <= 0 || ctas <= 0 ||
      items > 0x7fffffffLL || ctas > items || b0 <= 0 || b0 > B || x0 == nullptr ||
      (b0 > 1 && fs0 < plane) || (b0 < B && (x1 == nullptr || (B - b0 > 1 && fs1 < plane))) ||
      (ring && (row_bytes <= 0 || row_bytes % 16 != 0 || row_bytes > 2048 || pitch < row_bytes ||
                pitch % 128 != 0 || slab <= 0 || slab % (2 * ring_ry) != 0 || stages < 2 ||
                stages > kMaxStages || ly != 2 * ring_ry + 1 || copy < kTma || copy > kWarp ||
                (copy == kTma && ((static_cast<long long>(W) * sample_bytes) % 16 != 0 ||
                                  static_cast<long long>(W) * sample_bytes < row_bytes ||
                                  !aligned16(x0, fs0, sample_bytes) ||
                                  (b0 < B && !aligned16(x1, fs1, sample_bytes)))))) ||
      smem > 227 * 1024 ||
      (vec_out && (W % 16 != 0 || reinterpret_cast<uintptr_t>(out) % 16 != 0)) ||
      (sample_bytes == 1 ? maxval != 255 : !(maxval >= 255 && maxval <= 65535)))
    return static_cast<int>(cudaErrorInvalidValue);
  CUtensorMap map0 = {}, map1 = {};
  if (ring && copy == kTma) {
    const t360::EncodeTiled encode = t360::encode_tiled();
    if (encode == nullptr) return static_cast<int>(cudaErrorNotSupported);
    CUresult r = encode_source(&map0, encode, x0, fs0, b0, sample_bytes, H, W, row_bytes);
    if (r == CUDA_SUCCESS && b0 < B)
      r = encode_source(&map1, encode, x1, fs1, B - b0, sample_bytes, H, W, row_bytes);
    if (r != CUDA_SUCCESS) return -static_cast<int>(r);
  }
  Args a{x0,        x1,       fs0,   fs1,   b0,    out,  tiles,   kx,
         rx,        ky,       ry,    lx,    ly,    B,    H,       W,
         n_tiles,   parts,    row_bytes, pitch, slab, stages, copy, vec_out,
         static_cast<unsigned>(maxval),
         make_div(static_cast<unsigned>(B * parts)), make_div(static_cast<unsigned>(parts)),
         make_div(static_cast<unsigned>(ring ? row_bytes / sample_bytes : 1))};
  void* args[] = {&map0, &map1, &a};
  return f(k, dim3(ctas), dim3(threads_for(sample_bytes, ring_ry, cols)), smem, args);
}

}  // namespace

// One launch of K1 on stream, with c's fields: x0, x1, the two sources of
// the logical batch of B frames, read where they lie (ops/sources.py):
// frames [0, b0) from x0, [b0, B) from x1 (null when b0 == B), each
// [b, H, W] with packed rows, frames fs0 and fs1 samples apart; out:
// [B, H, W], stacked.  Samples of sample_bytes each
// (1: uint8; 2: uint16, rounded and saturated to maxval, the depth's
// largest sample); tiles:
// int32 [n_tiles, 6] (r0, c0, rows, cols, set, x0); kx float32 [sets, lx]
// and ky [sets, ly], each set's taps centred; rx/ry int32 [sets].
// ring_ry: 1 or 3 for the ring kernel (ly = 2*ring_ry+1; taps Gaussian),
// -1 for the direct kernel; cols: a ring thread's adjacent columns (8;
// uint8 at ring_ry 1: 8 or 16).  Each of the ctas CTAs walks every ctas-th of
// the n_tiles x B x parts (tile, frame, part) items.  The ring: `stages`
// stages (2 to 8) of `slab` rows (a multiple of 2 ring_ry), each row
// row_bytes (a multiple of 16, at most 2048) of the plane from sample x0
// (x0 * sample_bytes a multiple of 16: TMA starts a box 16-byte aligned),
// pitch bytes apart (a multiple of 128).  copy: 0, TMA (every source's
// base, rows and frame stride 16-byte aligned, and rows of at least
// row_bytes: a box is no wider than the plane; one tensor map a source);
// 1, the producer warp's loads.  vec_out: W a multiple
// of 16 and out 16-byte aligned.  Returns 0, a cudaError_t, or
// -CUresult if the tensor map cannot be encoded.  node: see
// t360::captured_node (null: not asked for).
extern "C" int t360_blur(const BlurCall* c, void* stream, void** node) {
  return with_launch(
      [&](const void* k, dim3 grid, dim3 block, int smem, void** args) {
        return t360::launch(k, grid, block, smem, args, static_cast<cudaStream_t>(stream), node);
      },
      *c);
}

// Re-points kernel node `node` of the instantiated graph `exec`, captured
// from a t360_blur launch, to the arguments c (t360::update_node): checked
// and built as t360_blur's, tensor maps encoded anew, so that a vec_out
// or a TMA copy that the new pointers do not allow is refused.  Returns
// as t360_blur does.
extern "C" int t360_blur_update(void* exec, void* node, const BlurCall* c) {
  return with_launch(
      [&](const void* k, dim3 grid, dim3 block, int smem, void** args) {
        return t360::update_node(exec, node, k, grid, block, smem, args);
      },
      *c);
}

// One instantiation's registers, local memory bytes (spills and stack),
// resident CTAs per SM, dynamic shared memory and threads per CTA for a
// launch with a ring of `stages` stages of `slab` rows `pitch` bytes
// apart: out[0..4].
extern "C" int t360_blur_attrs(int sample_bytes, int ring_ry, int cols, int pitch, int slab,
                               int stages, int* out) {
  const void* k = kernel_for(sample_bytes, ring_ry, cols);
  if (k == nullptr || (ring_ry > 0 && (stages < 2 || stages > kMaxStages)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, k);
  const int smem = smem_for(ring_ry, pitch, slab, stages);
  const int threads = threads_for(sample_bytes, ring_ry, cols);
  if (e == cudaSuccess) e = t360::allow_smem(k, smem);
  int blocks = 0;
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, k, threads, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  out[0] = fa.numRegs;
  out[1] = static_cast<int>(fa.localSizeBytes);
  out[2] = blocks;
  out[3] = smem;
  out[4] = threads;
  return 0;
}
