// K3: the remap on OpenCV's 1/32 grid, staged through shared memory one
// output tile at a time, with the half-up round, at every batch size, for
// uint8 planes and for uint16 planes (the 10-, 12- and 16-bit formats).
//
// Replaces the Pallas kernel transform360_tpu/ops/remap_pallas.py:441
// (_make_kernel, run by _run_class, entry remap_pallas) together with its
// XLA gather for oversized subtiles (_run_fallback, remap_pallas.py:639),
// its padded plane (pad_plane, :364) and the BORDER_TRANSPARENT fix-up the
// JAX pipeline applies after it (sampling.fixup_values).  It also computes
// the function of the lane-batched kernels B2-B4 (remap_lane.py), and of
// the plain version transform360_tpu_torch.sampling.remap_plain, bit for
// bit.  Its uint16 instantiation takes the place of the JAX package's XLA
// remap for the deep formats (sampling.remap_const / remap_traced followed
// by pipeline._round_px), which ran because B5 is uint8-only.
//
// What bounds it on the H100: the latency of its frame loop, then issue;
// not bytes.  A 4K luma frame is 8.3 MB in and 1.6 MB out (twice that at
// uint16), but every output pixel gathers T x T taps from anywhere in a
// window of the source, and each tap costs a load, a conversion, a product
// and a sum: 115 SASS instructions per pixel and frame in the frame loop at
// T = 4 (uint8; its copy loops apart), an issue bound of about 1.04 ms per
// batch-128 flagship step, which K3 reaches at about 55%.  The windows come
// from the plane as rows of 48-64 bytes (37 rows a 16x16 tile at the
// flagship), a gather of short row fragments.  Measured on the H100
// (PERF.md, K3 variants), these lose to the design below: TMA boxes or
// bulk copies per row from a producer warp (the TMA unit moves the short
// rows at about half the rate the CTAs' own 16-byte cp.async do), and a
// persistent grid over an mbarrier-paced ring in place of the CTA
// barriers (as many cycles per frame and CTA, with a longer tail).  Tensor
// cores do not apply: each pixel is a gather with its own weights, summed
// in a fixed order with every product and every sum rounded, which no
// matrix product (wgmma) computes.  K3 gives each CTA of 256 threads one
// 16x16 output tile, one pixel per thread: ops/window.py builds the plan on
// the CPU.  Per tile, once for its frames:
//   * the CTA resolves the border rule (wrap modulo the plane, clamp, or
//     REFLECT_101) for every 16-byte chunk of the tile's source window --
//     wh rows of `pitch` samples from a 16-byte-aligned column -- into a
//     chunk table in shared memory: the chunk's offset in a frame, or a
//     mark that it is copied sample by sample (across the seam or an edge,
//     or a plane whose rows are not 16-byte aligned).  No division or modulo runs in K3;
//   * each thread reads its pixel's plan entry (in flight while the table
//     is built) and its weights, row fy * 32 + fx of the float32 table
//     sampling.weight_table -- float32(w1[fy][ty] * w1[fx][tx]) of the
//     float64 taps, the very values the plain version forms -- in 16-byte
//     loads (no float64 product or conversion runs in K3).
// A CTA takes `frames` consecutive frames of the batch (blockIdx.y picks
// which), so that a short batch of few tiles still fills the card.  The
// batch is read where it lies, from up to two sources (the U and V planes
// of a chroma batch without a prefilter; ops/sources.py), each with its
// own base and frame stride: the frame groups are cut where source 1
// starts, so that a CTA picks its source once and its frame loop is the
// one-source loop.  Per
// frame the CTA issues one 16-byte cp.async per chunk from the table,
// double-buffered so that the next pass's windows load while this pass's
// are computed (the counterpart of the TPU kernel's double-buffered window
// DMA).  A launch gives its frames a pass (ops/window.py): one in the
// larger class; two in class 0, each thread copying its chunks of both
// frames (each table entry read once); or, in the WIDE instantiations,
// for class 0's small windows (3 KB at most) where they are nearly all
// of it and a CTA walks more than 16 frames, 8.  A wide pass's 8 x n
// copies, for a window of n chunks, are dealt over all 256 threads (item
// k: chunk k mod n of frame k / n, stepped by subtraction), so that every
// warp issues a share: with n under 256, as on the 2x2 supersampled
// cubemap's small windows (44 chunks a frame), a chunk-per-thread walk
// left the copies to the first warp or two, and the other warps waited for
// them at the pass's barrier; the 8 frames share the pass's two barriers
// and are summed two at a time.  K3 at 3072x2048 runs about 4% faster so
// (PERF.md §6).  Kept apart from the two-frame loop: a runtime switch, or
// wide and two-frame tiles in one launch, measured slower.  The windows'
// shared-space address and the thread's
// index are made once per CTA, opaque to the compiler: left to itself it
// read the CTA's id (SR_CgaCtaId) twice a pass to rebuild the address,
// and the thread's index once.  Together these took K3 about 10% faster
// at 3072x2048 (PERF.md §6).  The plan's window budgets are in bytes, so
// a uint16 window holds half the samples of a uint8 one.  Two frames'
// sums share the weights and interleave.  A thread reads each
// tap row as the aligned 32-bit words that hold it (4 samples a word at
// uint8, 2 at uint16; 2 words for T = 4 at uint8, never a word past the
// row's last tap), funnel-shifts them into place and turns each sample
// into a float with two full-rate instructions (PRMT to 0x4B0000bb or
// 0x4B00hhll, then one subtract; no I2F).  Converting each staged sample
// once per frame instead, into a float window that the taps read with one
// shared load each, measured slower at uint8 even where a window holds
// few samples a pixel (PERF.md §6): a float tap moves four bytes through
// the shared-memory pipe where one word of bytes serves four taps and
// several lanes, and that pipe is the tighter limit.  The sum runs ty-major,
// tx-minor, each product and each sum rounded on its own (-fmad=false;
// __fmul_rn/__fadd_rn), the fill term last; the round, saturated at 255 or
// at the depth's maximum, is full-rate too.  Tiles whose window exceeds
// the largest class (cubemap pole tiles) have pitch 0 and gather from
// device memory in this same kernel.
//
// Per pixel the plan holds ly | lx << 16 (window-relative first tap, in
// samples), fy (bit 7: outside the valid mask) and fx: 6 B.

#include "common.cuh"

namespace {

constexpr int kTH = 16, kTW = 16;  // output tile rows, columns
constexpr int kThreads = kTH * kTW;  // one output pixel per thread
constexpr uint32_t kBytewise = 0x80000000u;  // chunk-table mark: sample copies

// log2 of the samples in a 32-bit word and in a 16-byte chunk: 2 and 4
// for uint8 samples, 1 and 3 for uint16.
template <typename S>
constexpr int kLogWord = sizeof(S) == 1 ? 2 : 1;
template <typename S>
constexpr int kLogChunk = kLogWord<S> + 2;

constexpr int kMaxPass = 8;  // frames per pass, at most

// A launch's frames per pass: 1, or an even count up to kMaxPass (the wide
// loop sums them two at a time).
constexpr bool pass_ok(int pass_frames) {
  return pass_frames == 1 || (pass_frames % 2 == 0 && pass_frames > 0 && pass_frames <= kMaxPass);
}

// A CTA's dynamic shared memory: two passes of pass_frames frames' windows
// and the chunk table.
constexpr int smem_bytes(int win_bytes, int pass_frames) {
  return 2 * pass_frames * win_bytes + win_bytes / 4;
}

template <typename S>
struct Args {
  const S* src0;        // frames [0, b0) of the batch, [b0, H, W] with packed rows
  const S* src1;        // frames [b0, B) (null if b0 == B)
  int fs0, fs1;         // their frame strides in samples (< 2^31)
  int b0;
  int g0;               // frame groups of source 0 (grid rows [0, g0)), then source 1's
  S* dst;               // [B, out_h, out_w], stacked
  const int* meta;      // [n, 6]: out row, out col, y0, x0, wh, pitch (samples)
  const uint32_t* pos;  // [n * 256]: ly | lx << 16, tile rows of 16
  const uint8_t* fy;    // fy | (not valid) << 7
  const uint8_t* fx;
  const float* wtab;  // [32 * 32, T * T]: sampling.weight_table
  int B, H, W, out_h, out_w;
  int first, win_bytes;
  int frames;  // per CTA: frames [blockIdx.y * frames, ...) of the batch
  float fill;
  float maxval;  // uint16: the depth's largest sample (uint8: 255)
  bool vec;         // W, every source's base and frame stride are 16-byte aligned
  int pass_frames;  // frames per pass: 1, or even up to kMaxPass
};

// i mod n for 0 <= i < 2^31 by shift and subtract: the division unit's
// reciprocal (an I2F and MUFU.RCP sequence) is never used.
__device__ __noinline__ int rem(int i, int n) {
  for (int d = n << (__clz(n) - 1); d >= n; d >>= 1)
    if (i >= d) i -= d;
  return i;
}

// (i mod n) | (i / n) << 16 for 0 <= i <= 256 and n >= 1, by shift and
// subtract: a thread's first item of a pass's copies, and the step from
// one of its items to the next.
__device__ __forceinline__ uint32_t item_of(int i, int n) {
  int q = 0;
#pragma unroll
  for (int s = 8; s >= 0; --s)
    if (i >= (n << s)) i -= n << s, q |= 1 << s;
  return static_cast<uint32_t>(i) | static_cast<uint32_t>(q) << 16;
}

// The border rule on one index.  K3's indices lie within a period of the
// plane unless the plane is narrower than the taps and the 16-byte chunks,
// so one comparison settles them; rem() takes the rest.
template <int MODE>
__device__ __forceinline__ int resolve(int i, int n) {
  if (MODE == 0) {  // wrap
    if (i >= 0 && i < n) return i;
    if (i >= n && i - n < n) return i - n;
    return i >= 0 ? rem(i, n) : n - 1 - rem(-1 - i, n);
  }
  if (MODE == 2) {  // BORDER_REFLECT_101 (period 2n-2)
    if (n == 1) return 0;
    const int period = 2 * n - 2;
    int r = abs(i);
    if (r >= period) r = r - period < period ? r - period : rem(r, period);
    return r >= n ? period - r : r;
  }
  return t360::clamp_idx(i, n);  // fill: clamp, weight zeroed below
}

// The half-up round saturated to the sample's maximum (255, or maxval for
// uint16), with full-rate instructions: x + 0.5 clamped to [0, max],
// floored by adding 2^23 rounded down; the low bits of that float's bits
// are the result.
template <typename S>
__device__ __forceinline__ uint32_t round_sample(float x, float maxval) {
  const float mx = sizeof(S) == 1 ? 255.0f : maxval;
  const float c = fminf(fmaxf(__fadd_rn(x, 0.5f), 0.0f), mx);
  return __float_as_uint(__fadd_rd(c, 8388608.0f)) & (sizeof(S) == 1 ? 0xFFu : 0xFFFFu);
}

// Copy one 16-byte chunk of a frame's window to d, at the shared-space
// address ds; e is its table entry.
template <typename S, int MODE>
__device__ __forceinline__ void copy_chunk(const S* __restrict__ frame, S* d, unsigned ds,
                                           uint32_t e, int x0, int W) {
  if (!(e & kBytewise)) {
    t360::cp_async16(ds, frame + e);
  } else {
    constexpr int n = 1 << kLogChunk<S>;
    const S* row = frame + static_cast<size_t>(e & 0xFFFFu) * W;
    const int gx = x0 + (static_cast<int>((e >> 16) & 0x7FFFu) << kLogChunk<S>);
#pragma unroll
    for (int j = 0; j < n; ++j) d[j] = row[resolve<MODE>(gx + j, W)];
  }
}

// Once per tile: the table entry of every chunk of the window (chunk
// i = r * cpr + c lands at 16 i bytes into buf), and frame 0's copy of it.
template <typename S, int MODE>
__device__ __forceinline__ void chunk_table(const S* __restrict__ frame0, S* buf, unsigned sbuf,
                                            uint32_t* tab, int y0, int x0, int wh,
                                            int cpr, int H, int W, bool vec) {
  constexpr int lc = kLogChunk<S>;
  for (int r = threadIdx.x >> 4; r < wh; r += kThreads >> 4) {
    const int rr = resolve<MODE>(y0 + r, H);
    for (int c = threadIdx.x & 15; c < cpr; c += 16) {
      const int gx = x0 + (c << lc);
      // past the seam a wrapped window continues at column gx - W
      const int gv = (MODE == 0 && gx >= W) ? gx - W : gx;
      const uint32_t e = (vec && gv >= 0 && gv + (1 << lc) <= W)
                             ? static_cast<uint32_t>(rr * W + gv)
                             : kBytewise | static_cast<uint32_t>(c) << 16 |
                                   static_cast<uint32_t>(rr);
      const int i = r * cpr + c;
      tab[i] = e;
      copy_chunk<S, MODE>(frame0, buf + (i << lc), sbuf + (i << 4), e, x0, W);
    }
  }
}

// The window of frame `frame` into buf and, if two, that of frame + fs
// into buf + step, from the chunk table, each entry read once for both;
// sbuf is buf's shared-space address, tid the thread's index.
template <typename S, int MODE>
__device__ __forceinline__ void stage_pair(const S* __restrict__ frame, long long fs, bool two,
                                           S* buf, unsigned sbuf, int step, const uint32_t* tab,
                                           int n, int x0, int W, int tid) {
  for (int i = tid; i < n; i += kThreads) {
    const uint32_t e = tab[i];
    copy_chunk<S, MODE>(frame, buf + (i << kLogChunk<S>), sbuf + (i << 4), e, x0, W);
    if (two)
      copy_chunk<S, MODE>(frame + fs, buf + step + (i << kLogChunk<S>),
                          sbuf + step * sizeof(S) + (i << 4), e, x0, W);
  }
}

// The windows of `count` frames from `frame` on, fs samples apart, into
// buf, win samples apart, from the chunk table of n chunks a window: item
// k of the count x n copies is chunk k mod n of frame k / n.  This thread
// takes items first, first + 256, ..., each held as (chunk) | (frame) <<
// 16 (item_of), the next one `step` on, less n chunks where the chunk
// passes n.  sbuf is buf's shared-space address.
template <typename S, int MODE>
__device__ __forceinline__ void stage(const S* __restrict__ frame, int fs, int count, S* buf,
                                      unsigned sbuf, int win, const uint32_t* tab, int n,
                                      uint32_t first, uint32_t step, int x0, int W) {
  constexpr int lc = kLogChunk<S>;
  for (uint32_t k = first; static_cast<int>(k >> 16) < count;) {
    const int i = k & 0xFFFFu;
    const int j = k >> 16;
    const int off = j * win + (i << lc);  // samples into buf
    copy_chunk<S, MODE>(frame + static_cast<long long>(j) * fs, buf + off,
                        sbuf + off * static_cast<int>(sizeof(S)), tab[i], x0, W);
    k += step;
    if (static_cast<int>(k & 0xFFFFu) >= n) k += 0x10000u - n;
  }
}

// One pixel's sum over its T x T taps in the staged window, whose first
// tap is sample o of buf.  Each tap row is read as the aligned words that
// hold it: words o/P + min(i, last) for i = 0 .. (T+P-1)/P, where P is the
// samples per word and `last` the word of the row's last tap, so no load
// reaches past that tap.
template <typename S, int T>
__device__ __forceinline__ float sum_staged(const S* buf, int o, int pitch, const float* w) {
  constexpr int lw = kLogWord<S>;
  constexpr int P = 1 << lw;  // samples per word
  const uint32_t* base = reinterpret_cast<const uint32_t*>(buf + (o & ~(P - 1)));
  const int k = o & (P - 1);
  if (T == 1) return t360::sample_to_float<S>(base[0], k);
  constexpr int NQ = (T + P - 1) / P;  // words of taps per row
  const int last = (k + T - 1) >> lw;
  const int s = k << (sizeof(S) == 1 ? 3 : 4);
  const int pw = pitch >> lw;
  float acc = 0.0f;
#pragma unroll
  for (int ty = 0; ty < T; ++ty) {
    const uint32_t* row = base + ty * pw;
    uint32_t a[NQ + 1];
#pragma unroll
    for (int i = 0; i <= NQ; ++i) a[i] = row[i == 0 ? 0 : min(i, last)];
#pragma unroll
    for (int q = 0; q < NQ; ++q) {
      const uint32_t v = __funnelshift_r(a[q], a[q + 1], s);
#pragma unroll
      for (int j = 0; j < P && P * q + j < T; ++j) {
        const int tx = P * q + j;
        const float term = __fmul_rn(w[ty * T + tx], t360::sample_to_float<S>(v, j));
        acc = (ty == 0 && tx == 0) ? term : __fadd_rn(acc, term);
      }
    }
  }
  return acc;
}

// The same from device memory (tiles on the global path), first tap at
// source row y, column x before the border rule.  The empty asm keeps the
// compiler from hoisting every pixel's loads ahead of the sums: those
// registers would cost the staged tiles their occupancy.
template <typename S, int T, int MODE>
__device__ __forceinline__ float sum_global(const S* __restrict__ frame, int y, int x,
                                            int H, int W, const float* w) {
  float acc = 0.0f;
#pragma unroll
  for (int ty = 0; ty < T; ++ty) {
    asm volatile("" ::: "memory");
    const S* row = frame + static_cast<size_t>(resolve<MODE>(y + ty, H)) * W;
#pragma unroll
    for (int tx = 0; tx < T; ++tx) {
      const float g = t360::sample_to_float<S>(row[resolve<MODE>(x + tx, W)], 0);
      if (T == 1) return g;
      const float term = __fmul_rn(w[ty * T + tx], g);
      acc = (ty == 0 && tx == 0) ? term : __fadd_rn(acc, term);
    }
  }
  return acc;
}

// The fill term, the valid mask, the round and the store of one frame.
template <typename S, int T, int MODE>
__device__ __forceinline__ void put(S* out, float acc, float fill_term, bool invalid,
                                    uint32_t fill_px, float maxval, int oo) {
  if (oo < 0) return;
  const float v = (MODE == 1 && T > 1) ? __fadd_rn(acc, fill_term) : acc;
  out[oo] = static_cast<S>(invalid ? fill_px : round_sample<S>(v, maxval));
}

// Four CTAs per SM where a thread's weights are 16 registers or fewer (at
// most 64 registers), else two.  WIDE: more than two frames a pass, their
// copies dealt over every thread; else one or two, each thread copying its
// chunks of both.
template <typename S, int T, int MODE, bool WIDE>
__global__ void __launch_bounds__(kThreads, T * T <= 16 ? 4 : 2)
    window_kernel(const Args<S> a) {
  extern __shared__ __align__(16) unsigned char smem[];
  // frames per pass, two passes in flight: 1 or 2 unless WIDE (the
  // compiler knows as much)
  const int fp = WIDE ? a.pass_frames : a.pass_frames == 2 ? 2 : 1;
  uint32_t* tab = reinterpret_cast<uint32_t*>(smem + 2 * fp * a.win_bytes);
  S* const bufs = reinterpret_cast<S*>(smem);
  // bufs' shared-space address and this thread's index, made once and
  // opaque to the compiler, which would otherwise read the special
  // registers again at every pass
  unsigned sbufs;
  asm("mov.b32 %0, %1;" : "=r"(sbufs) : "r"(t360::smem_u32(smem)));
  int tid;
  asm("mov.u32 %0, %%tid.x;" : "=r"(tid));
  const int win = a.win_bytes / static_cast<int>(sizeof(S));  // samples per window

  const int t = a.first + blockIdx.x;
  const int* m = a.meta + 6 * t;
  const int y0 = m[2], x0 = m[3], wh = m[4], pitch = m[5];
  const bool staged = pitch > 0;  // uniform over the CTA
  const int nchunks = wh * (pitch >> kLogChunk<S>);
  const int N = a.out_h * a.out_w;  // < 2^31; offsets of frames are 64-bit products
  // this CTA's frames: nf frames of one source from its frame fz (frame
  // b0 + fz of the batch for source 1)
  const bool second = static_cast<int>(blockIdx.y) >= a.g0;
  const int fz = (second ? blockIdx.y - a.g0 : blockIdx.y) * a.frames;
  const int nf = min(a.frames, (second ? a.B - a.b0 : a.b0) - fz);
  const int fs = second ? a.fs1 : a.fs0;  // samples from one frame to the next
  const S* src = (second ? a.src1 : a.src0) + static_cast<long long>(fz) * fs;
  S* dst = a.dst + static_cast<long long>(second ? a.b0 + fz : fz) * N;

  // frame f + j of a pass with parity `half` (frame f its first) is
  // staged at bufs + (half * fp + j) * win
  // the pixel's plan entry is in flight while the chunk table is built,
  // and frame 0's window while the pixel is set up
  const size_t ip = static_cast<size_t>(t) * kThreads + threadIdx.x;
  const uint32_t ps = __ldg(a.pos + ip);
  const int fyb = __ldg(a.fy + ip);
  const int fx = __ldg(a.fx + ip);
  if (staged)
    chunk_table<S, MODE>(src, bufs, sbufs, tab, y0, x0, wh, pitch >> kLogChunk<S>, a.H, a.W,
                         a.vec);

  const int oy = m[0] + threadIdx.x / kTW;
  const int ox = m[1] + threadIdx.x % kTW;
  const int ly = static_cast<int>(ps & 0xFFFFu);
  const int lx = static_cast<int>(ps >> 16);
  const int fy = fyb & 0x7F;
  const bool invalid = (fyb >> 7) != 0;
  // staged: sample of the first tap in the window; else ly | lx << 16
  const int o = staged ? ly * pitch + lx : static_cast<int>(ps);
  const int oo = (oy < a.out_h && ox < a.out_w) ? oy * a.out_w + ox : -1;
  float w[T * T];
  float fill_w = 0.0f;
  if (T > 1) {
    const float4* row = reinterpret_cast<const float4*>(a.wtab + (fy * 32 + fx) * (T * T));
#pragma unroll
    for (int i = 0; i < T * T / 4; ++i) {
      const float4 v = __ldg(row + i);
      w[4 * i] = v.x, w[4 * i + 1] = v.y, w[4 * i + 2] = v.z, w[4 * i + 3] = v.w;
    }
    if (MODE == 1) {  // absolute coordinates decide what lies outside
#pragma unroll
      for (int ty = 0; ty < T; ++ty) {
#pragma unroll
        for (int tx = 0; tx < T; ++tx) {
          const int yy = y0 + ly + ty;
          const int xx = x0 + lx + tx;
          if (yy < 0 || yy >= a.H || xx < 0 || xx >= a.W) {
            fill_w = __fadd_rn(fill_w, w[ty * T + tx]);
            w[ty * T + tx] = 0.0f;
          }
        }
      }
    }
  }
  const float fill_term = __fmul_rn(fill_w, a.fill);
  const uint32_t fill_px = round_sample<S>(a.fill, a.maxval);
  // Each frame loop below sums frame f and, if two, f + 1, staged at buf
  // and buf + win, then rounds and stores them; the branches stay outside
  // the sums, so the two frames' sums interleave.  (One helper for both
  // loops took the two-frame loop from 62 registers to 64, and slower.)
  if (!WIDE) {  // one or two frames a pass
    if (staged) {
      __syncthreads();  // the chunk table is complete
      if (fp == 2 && nf > 1)
        stage_pair<S, MODE>(src + fs, 0, false, bufs + win, sbufs + win * sizeof(S), 0, tab,
                            nchunks, x0, a.W, tid);
      t360::cp_async_commit();
    }
    int half = 0;
    for (int f = 0; f < nf; f += fp) {
      const bool two = fp == 2 && f + 1 < nf;
      if (staged) {
        if (f + fp < nf)  // the next pass's frames
          stage_pair<S, MODE>(src + static_cast<long long>(f + fp) * fs, fs,
                              fp == 2 && f + fp + 1 < nf, bufs + (half ^ 1) * fp * win,
                              sbufs + (half ^ 1) * fp * win * sizeof(S), win, tab, nchunks, x0,
                              a.W, tid);
        t360::cp_async_commit();  // empty past the batch's end
        t360::cp_async_wait<1>();
        __syncthreads();  // this pass's windows are complete
      }
      float acc0, acc1 = 0.0f;
      const S* buf = bufs + half * fp * win;
      if (staged) {
        acc0 = sum_staged<S, T>(buf, o, pitch, w);
        if (two) acc1 = sum_staged<S, T>(buf + win, o, pitch, w);
      } else {
        const S* frame = src + static_cast<long long>(f) * fs;
        acc0 = sum_global<S, T, MODE>(frame, y0 + (o & 0xFFFF), x0 + (o >> 16), a.H, a.W, w);
        if (two)
          acc1 = sum_global<S, T, MODE>(frame + fs, y0 + (o & 0xFFFF), x0 + (o >> 16), a.H,
                                        a.W, w);
      }
      S* out = dst + static_cast<long long>(f) * N;
      put<S, T, MODE>(out, acc0, fill_term, invalid, fill_px, a.maxval, oo);
      if (two) put<S, T, MODE>(out + N, acc1, fill_term, invalid, fill_px, a.maxval, oo);
      if (staged) __syncthreads();  // this half is free for the pass after next
      half ^= 1;
    }
    return;
  }

  // fp (even) frames a pass, their copies dealt over every thread: this
  // thread's first item of a pass's copies, and the step to its next
  uint32_t first = 0, step = 0;
  if (staged) {
    first = item_of(tid, nchunks);
    step = item_of(kThreads, nchunks);
    __syncthreads();  // the chunk table is complete
    // the first pass's other frames (chunk_table copied frame 0)
    stage<S, MODE>(src + fs, fs, min(fp, nf) - 1, bufs + win, sbufs + win * sizeof(S), win, tab,
                   nchunks, first, step, x0, a.W);
    t360::cp_async_commit();
  }
  // two frames a trip: frame f is frame j of its pass, whose windows are
  // staged at its first frame and freed after its last
  int half = 0, j = 0;
  for (int f = 0; f < nf; f += 2) {
    if (staged && j == 0) {
      // the next pass's frames (none past the batch's end)
      stage<S, MODE>(src + static_cast<long long>(f + fp) * fs, fs, min(fp, nf - f - fp),
                     bufs + (half ^ 1) * fp * win, sbufs + (half ^ 1) * fp * win * sizeof(S),
                     win, tab, nchunks, first, step, x0, a.W);
      t360::cp_async_commit();  // empty past the batch's end
      t360::cp_async_wait<1>();
      __syncthreads();  // this pass's windows are complete
    }
    const bool two = f + 1 < nf;
    float acc0, acc1 = 0.0f;
    const S* buf = bufs + (half * fp + j) * win;
    if (staged) {
      acc0 = sum_staged<S, T>(buf, o, pitch, w);
      if (two) acc1 = sum_staged<S, T>(buf + win, o, pitch, w);
    } else {
      const S* frame = src + static_cast<long long>(f) * fs;
      acc0 = sum_global<S, T, MODE>(frame, y0 + (o & 0xFFFF), x0 + (o >> 16), a.H, a.W, w);
      if (two)
        acc1 = sum_global<S, T, MODE>(frame + fs, y0 + (o & 0xFFFF), x0 + (o >> 16), a.H,
                                      a.W, w);
    }
    S* out = dst + static_cast<long long>(f) * N;
    put<S, T, MODE>(out, acc0, fill_term, invalid, fill_px, a.maxval, oo);
    if (two) put<S, T, MODE>(out + N, acc1, fill_term, invalid, fill_px, a.maxval, oo);
    j += 2;
    if (j == fp) {  // the pass's last frames (a batch's last pass may end before)
      if (staged) __syncthreads();  // this half is free for the pass after next
      half ^= 1;
      j = 0;
    }
  }
}

template <typename S, int T, bool WIDE>
const void* with_mode(int mode) {
  switch (mode) {
    case 0: return reinterpret_cast<const void*>(window_kernel<S, T, 0, WIDE>);
    case 1: return reinterpret_cast<const void*>(window_kernel<S, T, 1, WIDE>);
    case 2: return reinterpret_cast<const void*>(window_kernel<S, T, 2, WIDE>);
    default: return nullptr;
  }
}

template <typename S, bool WIDE>
const void* with_taps(int taps, int mode) {
  switch (taps) {
    case 1: return with_mode<S, 1, WIDE>(mode);
    case 2: return with_mode<S, 2, WIDE>(mode);
    case 4: return with_mode<S, 4, WIDE>(mode);
    case 8: return with_mode<S, 8, WIDE>(mode);
    default: return nullptr;
  }
}

// The instantiation for a sample size (1: uint8, 2: uint16), T taps, a
// border mode and frames a pass (1 or 2; more: WIDE).
const void* kernel_for(int sample_bytes, int taps, int mode, int pass_frames) {
  const bool wide = pass_frames > 2;
  switch (sample_bytes) {
    case 1:
      return wide ? with_taps<uint8_t, true>(taps, mode) : with_taps<uint8_t, false>(taps, mode);
    case 2:
      return wide ? with_taps<uint16_t, true>(taps, mode) : with_taps<uint16_t, false>(taps, mode);
    default: return nullptr;
  }
}

}  // namespace

// The arguments of a launch of K3 (t360_window) and of a graph node's
// update (t360_window_update), as ops/window.py's WindowCall lays them out.
struct WindowCall {
  const void* src0;
  long long fs0;
  int b0;
  const void* src1;
  long long fs1;
  void* dst;
  int sample_bytes;
  float maxval;
  int B, H, W, out_h, out_w;
  const int* meta;
  const uint32_t* pos;
  const uint8_t* fy;
  const uint8_t* fx;
  const float* wtab;
  int first, tiles, win_bytes, taps, mode;
  float fill;
  int vec, frames, pass_frames;
};

namespace {

bool aligned16(const void* x, long long fs, int sample_bytes) {
  return reinterpret_cast<uintptr_t>(x) % 16 == 0 && (fs * sample_bytes) % 16 == 0;
}

// The kernel's Args for the call c, source 0's frame groups first.
template <typename S>
Args<S> args_of(const WindowCall& c, int g0) {
  return Args<S>{static_cast<const S*>(c.src0), static_cast<const S*>(c.src1),
                 static_cast<int>(c.fs0), static_cast<int>(c.fs1), c.b0, g0,
                 static_cast<S*>(c.dst), c.meta, c.pos, c.fy, c.fx, c.wtab,
                 c.B, c.H, c.W, c.out_h, c.out_w, c.first, c.win_bytes, c.frames, c.fill,
                 c.maxval, c.vec != 0, c.pass_frames};
}

// Checks a launch of K3 and builds its Args, then returns f(kernel, grid,
// shared memory, kernel arguments): a launch and a graph node's update
// take theirs from here alike.
template <typename F>
int with_launch(F&& f, const WindowCall& c) {
  const auto& [src0, fs0, b0, src1, fs1, dst, sample_bytes, maxval, B, H, W, out_h, out_w, meta,
               pos, fy, fx, wtab, first, tiles, win_bytes, taps, mode, fill, vec, frames,
               pass_frames] = c;
  const void* k = kernel_for(sample_bytes, taps, mode, pass_frames);
  const long long plane = static_cast<long long>(H) * W;
  const int g0 = frames > 0 ? (b0 + frames - 1) / frames : 0;  // source 0's frame groups
  const int groups = frames > 0 ? g0 + (B - b0 + frames - 1) / frames : 0;
  if (k == nullptr || B <= 0 || H <= 0 || W <= 0 || out_h <= 0 || out_w <= 0 ||
      tiles <= 0 || first < 0 || win_bytes < 0 || frames <= 0 || b0 <= 0 || b0 > B ||
      src0 == nullptr || (b0 > 1 && fs0 < plane) || fs0 > 0x7fffffffLL || fs1 > 0x7fffffffLL ||
      (b0 < B && (src1 == nullptr || (B - b0 > 1 && fs1 < plane))) ||
      static_cast<long long>(out_h) * out_w >= (1LL << 31) ||
      groups > 65535 || (win_bytes & 15) != 0 ||
      static_cast<long long>(H) * W >= (1LL << 31) || H >= (1 << 16) ||
      !pass_ok(pass_frames) || smem_bytes(win_bytes, pass_frames) > 227 * 1024 ||
      (vec && ((static_cast<long long>(W) * sample_bytes) % 16 != 0 ||
               !aligned16(src0, fs0, sample_bytes) ||
               (b0 < B && !aligned16(src1, fs1, sample_bytes)))) ||
      (sample_bytes == 1 ? maxval != 255.0f : !(maxval >= 255.0f && maxval <= 65535.0f)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = smem_bytes(win_bytes, pass_frames);
  const dim3 grid(tiles, groups);
  if (sample_bytes == 1) {
    Args<uint8_t> a = args_of<uint8_t>(c, g0);
    void* args[] = {&a};
    return f(k, grid, smem, args);
  }
  Args<uint16_t> a = args_of<uint16_t>(c, g0);
  void* args[] = {&a};
  return f(k, grid, smem, args);
}

}  // namespace

// One launch of K3 on stream, with c's fields: src0, src1, the batch's
// two sources, read where they lie (ops/sources.py): frames [0, b0) from
// src0, [b0, B) from src1 (null when b0 == B), each [b, H, W] with packed rows, frames fs0 and fs1 samples
// apart; dst: [B, out_h, out_w], stacked.  Samples of sample_bytes each
// (1: uint8; 2: uint16, rounded and saturated to maxval, the depth's
// largest sample); meta int32 [n, 6] (out row, out col, y0, x0, wh, pitch
// in samples; pitch 0: global path); pos uint32, fy/fx uint8 [n * 256],
// tiles of 16x16; wtab float32 [32 * 32, taps * taps].  Launches tiles
// first .. first + tiles - 1, each CTA with 2 * pass_frames * win_bytes of
// window buffers and win_bytes / 4 of chunk table (win_bytes a multiple of
// 16), and `frames` frames of the batch, pass_frames (1, or even up to
// kMaxPass) a pass, the groups cut where source 1 starts (a CTA reads one
// source).  vec: W and every source's base and frame stride are 16-byte
// aligned.  node: see
// t360::captured_node (null: not asked for).
extern "C" int t360_window(const WindowCall* c, void* stream, void** node) {
  return with_launch(
      [&](const void* k, dim3 grid, int smem, void** args) {
        return t360::launch(k, grid, dim3(kThreads), smem, args,
                            static_cast<cudaStream_t>(stream), node);
      },
      *c);
}

// Re-points kernel node `node` of the instantiated graph `exec`, captured
// from a t360_window launch, to the arguments c (t360::update_node),
// checked and built as t360_window's, so that a vec that the new pointers
// do not allow is refused.  Returns as t360_window does.
extern "C" int t360_window_update(void* exec, void* node, const WindowCall* c) {
  return with_launch(
      [&](const void* k, dim3 grid, int smem, void** args) {
        return t360::update_node(exec, node, k, grid, dim3(kThreads), smem, args);
      },
      *c);
}

// One instantiation's registers, local memory bytes (spills and stack),
// resident CTAs per SM and dynamic shared memory for a launch with
// win_bytes of window and pass_frames frames per pass: out[0..3].
extern "C" int t360_window_attrs(int sample_bytes, int taps, int mode, int win_bytes,
                                 int pass_frames, int* out) {
  const void* k = kernel_for(sample_bytes, taps, mode, pass_frames);
  if (k == nullptr || win_bytes < 0 || !pass_ok(pass_frames))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaFuncAttributes fa;
  cudaError_t e = cudaFuncGetAttributes(&fa, k);
  const int smem = smem_bytes(win_bytes, pass_frames);
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
