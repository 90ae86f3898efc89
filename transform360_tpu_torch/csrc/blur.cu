// K1: the adaptive low-pass prefilter, with the half-up round to uint8.
//
// Replaces the Pallas kernel transform360_tpu/ops/blur_lane.py:269
// (_make_kernel, entry blur_lane).  It computes what
// transform360_tpu.filtering.apply_blur followed by pipeline._round_u8
// computes, and what transform360_tpu_torch.filtering.blur_plain + round
// computes, bit for bit: per latitude band, a horizontal pass with
// per-column taps, then a vertical pass, in float32, each product and
// each sum rounded on its own (built with -fmad=false, and the
// __fmul_rn/__fadd_rn intrinsics are never contracted), in the plain
// version's tap order.
//
// Layout: batch-major uint8 [B, H, W].  The TPU kernel keeps 128 frames
// in the vector lanes ([H, W, 128]) and runs the x pass as a banded
// Toeplitz matmul on the MXU; both are TPU artifacts and are not carried
// over.
//
// The band raster is flattened on the host (ops/blur.py):
//   * scratch row s holds the horizontal pass of source row s_src[s] with
//     the taps of band s_band[s].  Each band (per stereo eye) owns
//     height + 2*ry scratch rows, because the vertical taps of a band's
//     output rows read neighbour rows filtered with THAT band's x taps,
//     exactly as apply_blur slices rows [top - ry, top + height + ry);
//   * output row r reads scratch rows row_s0[r] .. row_s0[r] + 2*ry with
//     the taps of band row_band[r] (-1: the zeroed leftover row of odd
//     TB stereo dims);
//   * column c uses blur segment col_seg[c] (eye-folded for LR; -1: the
//     zeroed leftover column of odd LR dims);
//   * kx/ky hold each (band, segment)'s taps centred in a row of
//     lx = 2*RX+1 / ly = 2*RY+1 floats (RX, RY: the plan's largest
//     radii); a band of radius rx reads the middle 2*rx+1.  Any radius is
//     served: the tables stay in global memory (L1-resident), so the
//     adaptive 32x15 plan's ~87-tap polar kernels need no cap.
// Source rows and columns outside the plane clamp to the edge (replicate
// only at true plane edges; seams read real neighbours).
//
// What bounds it on the H100: memory traffic.  Per 4K luma frame the
// input is 8.3 MB of uint8, but the float32 scratch is ~33 MB, written
// by the first pass and read 2*ry+1 times by the second (mostly from
// L2).  The design keeps the first version simple and right: one thread
// per (frame, row, column), coalesced along columns, no shared memory.
// The wrapper chunks the batch so the scratch stays bounded.  Fusing the
// two passes through a shared-memory tile, which removes the scratch
// round trip, is later work.

#include "common.cuh"

namespace {

constexpr int kBlock = 256;

__global__ void blur_h_kernel(const uint8_t* __restrict__ x,
                              float* __restrict__ h, int H, int W, int S,
                              const int* __restrict__ s_src,
                              const int* __restrict__ s_band,
                              const int* __restrict__ col_seg,
                              const float* __restrict__ kx,
                              const int* __restrict__ rx_of, int nseg,
                              int lx) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int s = blockIdx.y;
  const int f = blockIdx.z;
  if (c >= W) return;
  const int g = s_band[s];
  int seg = col_seg[c];
  if (seg < 0) seg = 0;  // zeroed leftover column: the value is unused
  const int rx = rx_of[g];
  const float* k =
      kx + (static_cast<size_t>(g) * nseg + seg) * lx + ((lx - 1) / 2 - rx);
  const uint8_t* row = x + (static_cast<size_t>(f) * H + s_src[s]) * W;
  float acc = 0.0f;
  for (int u = 0; u <= 2 * rx; ++u) {
    const float p = static_cast<float>(row[t360::clamp_idx(c + u - rx, W)]);
    const float term = __fmul_rn(k[u], p);
    acc = (u == 0) ? term : __fadd_rn(acc, term);
  }
  h[(static_cast<size_t>(f) * S + s) * W + c] = acc;
}

__global__ void blur_v_kernel(const float* __restrict__ h,
                              uint8_t* __restrict__ out, int H, int W, int S,
                              const int* __restrict__ row_band,
                              const int* __restrict__ row_s0,
                              const int* __restrict__ col_seg,
                              const float* __restrict__ ky,
                              const int* __restrict__ ry_of, int nseg,
                              int ly) {
  const int c = blockIdx.x * blockDim.x + threadIdx.x;
  const int r = blockIdx.y;
  const int f = blockIdx.z;
  if (c >= W) return;
  const int g = row_band[r];
  const int seg = col_seg[c];
  uint8_t v = 0;
  if (g >= 0 && seg >= 0) {
    const int ry = ry_of[g];
    const float* k =
        ky + (static_cast<size_t>(g) * nseg + seg) * ly + ((ly - 1) / 2 - ry);
    const float* col = h + (static_cast<size_t>(f) * S + row_s0[r]) * W + c;
    float acc = 0.0f;
    for (int t = 0; t <= 2 * ry; ++t) {
      const float term = __fmul_rn(k[t], col[static_cast<size_t>(t) * W]);
      acc = (t == 0) ? term : __fadd_rn(acc, term);
    }
    v = t360::round_u8(acc);
  }
  out[(static_cast<size_t>(f) * H + r) * W + c] = v;
}

}  // namespace

// x: uint8 [B, H, W]; scratch: float32 [B, S, W]; out: uint8 [B, H, W].
// Tables as described above, all on the device.
extern "C" int t360_blur(const uint8_t* x, float* scratch, uint8_t* out,
                         int B, int H, int W, int S, const int* s_src,
                         const int* s_band, const int* row_band,
                         const int* row_s0, const int* col_seg,
                         const float* kx, const int* rx_of, int lx,
                         const float* ky, const int* ry_of, int ly, int nseg,
                         void* stream) {
  if (B <= 0 || B > 65535 || H <= 0 || H > 65535 || S <= 0 || S > 65535 ||
      W <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 block(kBlock);
  const dim3 grid_h((W + kBlock - 1) / kBlock, S, B);
  blur_h_kernel<<<grid_h, block, 0, st>>>(x, scratch, H, W, S, s_src, s_band,
                                          col_seg, kx, rx_of, nseg, lx);
  T360_CHECK_LAUNCH();
  const dim3 grid_v((W + kBlock - 1) / kBlock, H, B);
  blur_v_kernel<<<grid_v, block, 0, st>>>(scratch, out, H, W, S, row_band,
                                          row_s0, col_seg, ky, ry_of, nseg, ly);
  T360_CHECK_LAUNCH();
  return 0;
}
