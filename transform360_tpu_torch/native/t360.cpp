// transform360_tpu native engine: a dependency-free C++17 implementation of
// the full Transform360 CPU pipeline, exposed through a C ABI that mirrors
// the reference's stable library surface
// (reference: Transform360/Library/VideoFrameTransformHandler.h:24-47).
//
// Role in this framework: host-side fallback engine (run the exact same
// configs without a TPU), cross-validation oracle for the JAX path, and the
// native runtime component replacing the reference's C++/OpenCV library.
// The math transcribes the behavior of VideoFrameTransform.cpp (geometry
// :796-1316, map gen :504-576, prefilter :77-501/579-704, remap semantics
// of cv::remap with OpenCV's 1/32-px fixed-point quantization, INTER_AREA
// :735-777) without using OpenCV; resampling and filtering are implemented
// directly.  Segment filtering honors enable_multi_threading with a
// std::thread fan-out, like the reference.
//
// Build: make -C transform360_tpu/native  (produces libt360.so)

#include <algorithm>
#include <atomic>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <thread>
#include <vector>

namespace {

constexpr float kSide = 0.5f;
constexpr double kEps = 1e-9;
constexpr double kPi = 3.14159265358979323846;
constexpr double kSphereArea = 4 * kPi;
constexpr double kFovC = 0.5333 * kPi;

enum Layout {
  L_CUBEMAP_32 = 0,
  L_CUBEMAP_23_OFFCENTER = 1,
  L_FLAT_FIXED = 2,
  L_EQUIRECT = 3,
  L_BARREL = 4,
  L_BARREL_SPLIT = 5,
  L_EAC_32 = 6,
};

enum Stereo { S_TB = 0, S_LR = 1, S_MONO = 2, S_GUESS = 3 };
enum Interp { I_NEAREST = 0, I_LINEAR = 1, I_CUBIC = 2, I_LANCZOS4 = 4 };

// Mirrors transform360_tpu.config.TransformConfig field order (and the
// reference FrameTransformContext, VideoFrameTransformHelper.h:56-90).
struct Ctx {
  int32_t input_layout;
  int32_t output_layout;
  int32_t input_stereo_format;
  int32_t output_stereo_format;
  int32_t vflip;
  float input_expand_coef;
  float expand_coef;
  int32_t interpolation_alg;
  float width_scale_factor;
  float height_scale_factor;
  float fixed_yaw;
  float fixed_pitch;
  float fixed_roll;
  float fixed_hfov;
  float fixed_vfov;
  float fixed_cube_offcenter_x;
  float fixed_cube_offcenter_y;
  float fixed_cube_offcenter_z;
  int32_t is_horizontal_offset;
  int32_t enable_low_pass_filter;
  float kernel_height_scale_factor;
  float min_kernel_half_height;
  float max_kernel_half_height;
  int32_t enable_multi_threading;
  int32_t num_vertical_segments;
  int32_t num_horizontal_segments;
  int32_t adjust_kernel;
  float kernel_adjust_factor;
};

// ---------------------------------------------------------------------------
// Geometry (transcribed behavior of VideoFrameTransform.cpp:893-1316)
// ---------------------------------------------------------------------------

struct V3 {
  float x, y, z;
};

static const V3 kP0{-0.5f, -0.5f, -0.5f}, kP1{0.5f, -0.5f, -0.5f},
    kP3{0.5f, 0.5f, -0.5f}, kP4{-0.5f, -0.5f, 0.5f}, kP5{0.5f, -0.5f, 0.5f},
    kP6{-0.5f, 0.5f, 0.5f};
static const V3 kPX{1, 0, 0}, kPY{0, 1, 0}, kPZ{0, 0, 1}, kNX{-1, 0, 0},
    kNZ{0, 0, -1};

struct Basis {
  V3 p, vx, vy;
};

// face -> basis, standard (VideoFrameTransform.cpp:1153-1184)
static const Basis kStd[6] = {
    {kP5, kNZ, kPY}, {kP0, kPZ, kPY}, {kP6, kPX, kNZ},
    {kP0, kPX, kPZ}, {kP4, kPX, kPY}, {kP1, kNX, kPY},
};
// face -> basis, 2x3 offcenter (:1120-1151)
static const Basis kOff[6] = {
    {kP4, kPY, kNZ}, {kP3, kNX, kPZ}, {kP5, kPY, kNX},
    {kP1, kNX, kPY}, {kP1, kPY, kPZ}, {kP5, kNX, kNZ},
};

static float intersectSphereOffset(float x, float y, float z, float ox,
                                   float oy, float oz) {
  float loc = x * -ox + y * -oy + z * -oz;
  float odot = ox * ox + oy * oy + oz * oz;
  float root = loc * loc - odot + 1.0f;
  if (root <= 0.0f) return 0.0f;
  root = std::sqrt(root);
  if (root < loc) return 0.0f;
  return root - loc;
}

static void normalizeEquirect(float x, float y, float* xo, float* yo) {
  if (y >= 1.0f) {
    y = 2.0f - y;
    x += 0.5f;
  } else if (y < 0.0f) {
    y = -y;
    x += 0.5f;
  }
  if (x >= 1.0f) {
    x -= (int)x;
  } else if (x < 0.0f) {
    x += (int)(-x) + 1;
  }
  *xo = x;
  *yo = y;
}

static void cubeFacePos(const Ctx& c, float tx, float ty, float tz, float* ox,
                        float* oy) {
  const float e = c.input_expand_coef;
  float x, y;
  if (tz <= -kSide) {
    x = tx / tz;
    y = ty / tz;
    if (x >= -1 && x <= 1 && y >= -1 && y <= 1) {
      *ox = (5.0f + x / e) / 6.0f;
      *oy = (3.0f + y / e) / 4.0f;
      return;
    }
  }
  if (tz >= kSide) {
    x = tx / tz;
    y = ty / tz;
    if (x >= -1 && x <= 1 && y >= -1 && y <= 1) {
      *ox = (3.0f + x / e) / 6.0f;
      *oy = (3.0f - y / e) / 4.0f;
      return;
    }
  }
  if (tx <= -kSide) {
    x = tz / tx;
    y = ty / tx;
    if (x >= -1 && x <= 1 && y >= -1 && y <= 1) {
      *ox = (3.0f - x / e) / 6.0f;
      *oy = (1.0f + y / e) / 4.0f;
      return;
    }
  }
  if (tx >= kSide) {
    x = tz / tx;
    y = ty / tx;
    if (x >= -1 && x <= 1 && y >= -1 && y <= 1) {
      *ox = (1.0f - x / e) / 6.0f;
      *oy = (1.0f - y / e) / 4.0f;
      return;
    }
  }
  if (ty <= -kSide) {
    x = tx / ty;
    y = tz / ty;
    if (x >= -1 && x <= 1 && y >= -1 && y <= 1) {
      *ox = (1.0f - x / e) / 6.0f;
      *oy = (3.0f + y / e) / 4.0f;
      return;
    }
  }
  if (ty >= kSide) {
    x = tx / ty;
    y = tz / ty;
    if (x >= -1 && x <= 1 && y >= -1 && y <= 1) {
      *ox = (5.0f + x / e) / 6.0f;
      *oy = (1.0f + y / e) / 4.0f;
      return;
    }
  }
  *ox = -1.0f;
  *oy = 0.0f;
}

static void inputPos(const Ctx& c, float tx, float ty, float tz,
                     float inputPixelWidth, float* ox, float* oy) {
  float d = std::sqrt(tx * tx + ty * ty + tz * tz);
  if (c.input_layout == L_CUBEMAP_32) {
    cubeFacePos(c, tx / d, ty / d, tz / d, ox, oy);
    return;
  }
  float x = -std::atan2(-tx / d, tz / d) / (2.0f * (float)kPi) + 0.5f;
  if (c.output_layout == L_BARREL || c.output_layout == L_BARREL_SPLIT) {
    x = std::min(x, 1.0f - inputPixelWidth * 0.5f);
    x = std::max(x, inputPixelWidth * 0.5f);
  }
  float s = -ty / d;
  s = std::max(-1.0f, std::min(1.0f, s));
  *ox = x;
  *oy = std::asin(s) / (float)kPi + 0.5f;
}

static bool transformPos(const Ctx& c, float x, float y, float* outX,
                         float* outY, float inputPixelWidth) {
  int isRight = 0;
  if (c.input_stereo_format != S_MONO) {
    if (c.output_stereo_format == S_LR) {
      if (x > 0.5f) {
        x = (x - 0.5f) / 0.5f;
        isRight = 1;
      } else {
        x = x / 0.5f;
      }
    } else if (c.output_stereo_format == S_TB) {
      if (y > 0.5f) {
        y = (y - 0.5f) / 0.5f;
        if (c.vflip) y = 1.0f - y;
        isRight = 1;
      } else {
        y = y / 0.5f;
      }
    }
  }

  bool hasMapping = true;
  if (c.output_layout != L_FLAT_FIXED) y = 1.0f - y;

  float yaw = 0, pitch = 0;
  int face = 0;
  const float coef = c.expand_coef;
  bool useAngles = false;

  switch (c.output_layout) {
    case L_CUBEMAP_32: {
      int vf = (int)(y * 2), hf = (int)(x * 3);
      x = x * 3.0f - hf;
      y = y * 2.0f - vf;
      face = hf + (1 - vf) * 3;
      break;
    }
    case L_CUBEMAP_23_OFFCENTER: {
      int vf = (int)(y * 3), hf = (int)(x * 2);
      x = x * 2.0f - hf;
      y = y * 3.0f - vf;
      face = hf + (2 - vf) * 2;
      break;
    }
    case L_FLAT_FIXED:
      break;
    case L_EQUIRECT:
      yaw = (2.0f * x - 1.0f) * (float)kPi;
      pitch = (y - 0.5f) * (float)kPi;
      useAngles = true;
      break;
    case L_BARREL: {
      if (x <= 0.8f) {
        yaw = (2.5f * x - 1.0f) * coef * (float)kPi;
        pitch = (y * 0.5f - 0.25f) * coef * (float)kPi;
        useAngles = true;
      } else {
        int vf = (int)(y * 2);
        face = (vf == 1) ? 2 : 3;  // TOP : BOTTOM
        x = x * 5.0f - 4.0f;
        y = y * 2.0f - vf;
      }
      break;
    }
    case L_BARREL_SPLIT: {
      if (3.0f * x <= 2.0f) {
        int vf = (int)(y * 2);
        yaw = ((1.5f * x - 0.5f) * coef - vf + 1.0f) * (float)kPi;
        pitch = (y - 0.25f - 0.5f * vf) * coef * (float)kPi;
        useAngles = true;
      } else {
        int hv = (int)(y * 4);
        face = (hv == 1 || hv == 3) ? 2 : 3;
        x = x * 3.0f - 2.0f;
        switch (hv) {
          case 0:
            y = y * 2.0f;
            x = 1.0f - x;
            y = (0.5f - y) * coef;
            break;
          case 1:
            y = y * 2.0f;
            x = 1.0f - x;
            y = 1.0f - coef * (y - 0.5f);
            break;
          case 2:
            y = y * 2.0f - 0.5f;
            y = 1.0f - coef * (1.0f - y);
            break;
          default:
            y = y * 2.0f - 1.5f;
            y = y * coef;
            break;
        }
      }
      break;
    }
    case L_EAC_32: {
      int vf = (int)(y * 2), hf = (int)(x * 3);
      x = x * 3.0f - hf;
      y = y * 2.0f - vf;
      x = std::tan((x - 0.5f) * (float)kPi * 0.5f) * 0.5f + 0.5f;
      y = std::tan((y - 0.5f) * (float)kPi * 0.5f) * 0.5f + 0.5f;
      face = hf + (1 - vf) * 3;
      break;
    }
    default:
      return false;
  }

  if (c.output_layout == L_FLAT_FIXED) {
    float ox = ((x - 0.5f) * c.fixed_hfov + c.fixed_yaw) / 360.0f + 0.5f;
    float oy = ((y - 0.5f) * c.fixed_vfov - c.fixed_pitch) / 180.0f + 0.5f;
    normalizeEquirect(ox, oy, outX, outY);
  } else {
    float qx, qy, qz;
    if (useAngles) {
      qx = std::sin(yaw) * std::cos(pitch);
      qy = std::sin(pitch);
      qz = std::cos(yaw) * std::cos(pitch);
    } else {
      if (c.output_layout == L_BARREL || c.output_layout == L_BARREL_SPLIT) {
        float radius = (x - 0.5f) * (x - 0.5f) + (y - 0.5f) * (y - 0.5f);
        if (radius > 0.25f * coef * coef) hasMapping = false;
      }
      x = (x - 0.5f) * coef + 0.5f;
      y = (y - 0.5f) * coef + 0.5f;
      const Basis* tbl =
          (c.output_layout == L_CUBEMAP_23_OFFCENTER) ? kOff : kStd;
      const Basis& b = tbl[face];
      qx = b.p.x + b.vx.x * x + b.vy.x * y;
      qy = b.p.y + b.vx.y * x + b.vy.y * y;
      qz = b.p.z + b.vx.z * x + b.vy.z * y;
    }

    if (hasMapping) {
      float ox = c.fixed_cube_offcenter_x, oy = c.fixed_cube_offcenter_y,
            oz = c.fixed_cube_offcenter_z;
      if (std::abs(ox) > kEps || std::abs(oy) > kEps || std::abs(oz) > kEps) {
        float d = std::sqrt(qx * qx + qy * qy + qz * qz);
        qx /= d;
        qy /= d;
        qz /= d;
        if (c.is_horizontal_offset) {
          d = std::sqrt(qx * qx + qz * qz);
          qx /= d;
          qy /= d;  // parity quirk (VideoFrameTransform.cpp:1201-1204)
          qz /= d;
          float dist = intersectSphereOffset(qx, 0, qz, ox, 0, oz);
          if (dist > 0.0f) {
            qx = qx * dist - ox;
            qz = qz * dist - oz;
          }
        } else {
          float dist = intersectSphereOffset(qx, qy, qz, ox, oy, oz);
          if (dist > 0.0f) {
            qx = qx * dist - ox;
            qy = qy * dist - oy;
            qz = qz * dist - oz;
          }
        }
      }

      float s1 = std::sin(c.fixed_yaw * (float)kPi / 180.0f);
      float s2 = std::sin(c.fixed_pitch * (float)kPi / 180.0f);
      float s3 = std::sin(c.fixed_roll * (float)kPi / 180.0f);
      float c1 = std::cos(c.fixed_yaw * (float)kPi / 180.0f);
      float c2 = std::cos(c.fixed_pitch * (float)kPi / 180.0f);
      float c3 = std::cos(c.fixed_roll * (float)kPi / 180.0f);
      float tx = qx * (c1 * c3 + s1 * s2 * s3) - qy * (c3 * s1 * s2 - c1 * s3) +
                 qz * (c2 * s1);
      float ty = qx * (c2 * s3) - qy * (c2 * c3) + qz * (-s2);
      float tz = qx * (c1 * s2 * s3 - c3 * s1) -
                 qy * (c1 * c3 * s2 + s1 * s3) + qz * (c1 * c2);
      ty = -ty;
      inputPos(c, tx, ty, tz, inputPixelWidth, outX, outY);
    }
  }

  if (hasMapping) {
    if (c.input_stereo_format == S_TB) {
      *outY = *outY * 0.5f + (isRight ? 0.5f : 0.0f);
    } else if (c.input_stereo_format == S_LR) {
      *outX = *outX * 0.5f + (isRight ? 0.5f : 0.0f);
    }
  } else {
    *outX = -1.0f;
    *outY = 0.0f;
  }
  return true;
}

// ---------------------------------------------------------------------------
// Prefilter plan (VideoFrameTransform.cpp:77-94, 210-501)
// ---------------------------------------------------------------------------

// sigma stays double until the half-length truncation, which narrows to
// float exactly like filtering.calculate_kernel (f32(sigma) * f32(2);
// the reference's `int boxHalfLength = sigma * 2` on a C++ float) — the
// narrowing point decides kernel length at exact-integer boundaries, so
// both engines must narrow at the same spot.
static std::vector<float> calcKernel(double sigma) {
  int half = (int)((float)sigma * 2.0f);
  std::vector<float> k(2 * half + 1);
  double sc = std::abs(sigma) < kEps ? 0.0 : 0.5 / (sigma * sigma);
  double sum = 0;
  for (int u = -half; u <= half; ++u) {
    double v = std::exp(-(u * (double)u * sc));
    k[u + half] = (float)v;
    sum += v;
  }
  for (auto& v : k) v = (float)(v / sum);
  return k;
}

static double angDist(double y1, double p1, double y2, double p2) {
  double v = std::sin(p1) * std::sin(p2) +
             std::cos(p1) * std::cos(p2) * std::cos(y1 - y2);
  return std::acos(std::max(-1.0, std::min(1.0, v)));
}

static double samplingArc(double off, double arc) {
  return kPi - 2 * std::atan2(std::cos(0.5 * arc) - off, std::sin(0.5 * arc));
}

static double sphericalArea(double a) { return (1 - std::cos(0.5 * a)) * 2 * kPi; }

static double effRatio(double dist, double off) {
  const double fov = kFovC;
  double major;
  if (dist - kEps > fov / 2) {
    if (dist + fov / 2 > kPi) {
      double e1 = samplingArc(off, (2 * kPi - dist - fov / 2) * 2) / 2;
      double e2 = samplingArc(off, (dist - fov / 2) * 2) / 2;
      major = (2 * kPi - e1 - e2) / fov;
    } else {
      major = (samplingArc(off, 2 * dist + fov) -
               samplingArc(off, 2 * dist - fov)) / 2 / fov;
    }
  } else {
    major = (samplingArc(off, 2 * dist + fov) +
             samplingArc(off, fov - 2 * dist)) / 2 / fov;
  }
  double covert = angDist(dist, 0.5 * fov, 0.0, 0.0);
  double minor = samplingArc(off, covert * 2) / (covert * 2);
  return std::min(major * minor * sphericalArea(fov) / kSphereArea, 1.0);
}

struct Segment {
  int left, top, width, height;
  std::vector<float> kx, ky;
};

static void bandSegments(const Ctx& c, int top, int bottom, double angle,
                         float sigmaY, const std::vector<float>& kernelY,
                         int inW, int inH, std::vector<Segment>& out) {
  // double until calcKernel's narrow, matching filtering.py's f64 math
  double sigmaX =
      std::min(0.5 * inW, (double)sigmaY / (std::cos(angle) + kEps));
  std::vector<float> kernelX = calcKernel(sigmaX);
  int nhs = c.adjust_kernel ? c.num_horizontal_segments : 1;
  int segW = (int)std::ceil(1.0 * inW / nhs);
  double baseER = effRatio(0.0, 0.0);
  for (int i = 0; i < nhs && i * segW < inW; ++i) {
    int width = std::min(segW, inW - i * segW);
    Segment s;
    s.left = i * segW;
    s.top = top;
    s.width = width;
    s.height = bottom - top + 1;
    if (c.adjust_kernel) {
      double avgYaw =
          2 * kPi * ((i * segW + 0.5 * width) - 0.5 * inW) / inW;
      double avgPitch = 0.5 * kPi * (inH - top - bottom) / inH;
      double yaw = c.fixed_yaw * kPi / 180.0;
      double pitch = c.fixed_pitch * kPi / 180.0;
      double off = std::abs(c.fixed_cube_offcenter_z);
      if (std::abs(yaw) < kEps && std::abs(pitch) < kEps &&
          (std::abs(c.fixed_cube_offcenter_x) > kEps ||
           std::abs(c.fixed_cube_offcenter_y) > kEps ||
           c.fixed_cube_offcenter_z > kEps)) {
        off = std::sqrt(c.fixed_cube_offcenter_x * c.fixed_cube_offcenter_x +
                        c.fixed_cube_offcenter_y * c.fixed_cube_offcenter_y +
                        c.fixed_cube_offcenter_z * c.fixed_cube_offcenter_z);
        yaw = std::atan2(-c.fixed_cube_offcenter_x / off,
                         -c.fixed_cube_offcenter_z / off);
        pitch = std::asin(-c.fixed_cube_offcenter_y / off);
      }
      double dist = angDist(yaw, pitch, avgYaw, avgPitch);
      double scale = c.kernel_adjust_factor * baseER / effRatio(dist, off);
      s.kx = calcKernel(scale * sigmaX);
      s.ky = calcKernel(scale * sigmaY);
    } else {
      s.kx = kernelX;
      s.ky = kernelY;
    }
    out.push_back(std::move(s));
  }
}

static std::vector<Segment> filteringConfig(const Ctx& c, int inW, int inH,
                                            int outW, int outH) {
  if (c.input_stereo_format == S_LR) inW = (int)(inW * 0.5);
  if (c.input_stereo_format == S_TB) inH = (int)(inH * 0.5);
  if (c.output_stereo_format == S_LR) outW = (int)(outW * 0.5);
  if (c.output_stereo_format == S_TB) outH = (int)(outH * 0.5);

  float hFov, vFov;
  switch (c.output_layout) {
    case L_CUBEMAP_32:
    case L_EAC_32:
      hFov = 270;
      vFov = 180;
      break;
    case L_CUBEMAP_23_OFFCENTER:
      hFov = 180;
      vFov = 270;
      break;
    case L_FLAT_FIXED:
      hFov = c.fixed_hfov;
      vFov = c.fixed_vfov;
      break;
    case L_EQUIRECT:
      hFov = 360;
      vFov = 180;
      break;
    default:  // barrel layouts
      hFov = 450;
      vFov = 90;
      break;
  }
  float sigmaY =
      0.5f * std::min(c.max_kernel_half_height,
                      std::max(c.min_kernel_half_height,
                               c.kernel_height_scale_factor *
                                   std::min(inW / 360.0f, inH / 180.0f) /
                                   std::max(outW / hFov, outH / vFov)));
  std::vector<float> kernelY = calcKernel(sigmaY);
  int baseH = (int)std::ceil(1.0 * inH / c.num_vertical_segments);
  std::vector<Segment> segs;

  auto bandsFrom = [&](int startTop, int startBottom) {
    for (int bottom = startBottom; bottom >= 0; bottom -= baseH) {
      int top = std::max(bottom - baseH + 1, 0);
      double angle = 0.5 * kPi * (inH - top - bottom) / inH;
      bandSegments(c, top, bottom, angle, sigmaY, kernelY, inW, inH, segs);
    }
    for (int top = startTop; top < inH; top += baseH) {
      int bottom = std::min(top + baseH - 1, inH - 1);
      double angle = 0.5 * kPi * (top + bottom - inH) / inH;
      bandSegments(c, top, bottom, angle, sigmaY, kernelY, inW, inH, segs);
    }
  };

  if (c.num_vertical_segments % 2 == 0) {
    bandsFrom((int)(0.5 * inH), (int)(0.5 * inH) - 1);
  } else {
    int top = (int)(0.5 * (inH - baseH));
    int bottom = top + baseH - 1;
    bandSegments(c, top, bottom, 0.0f, sigmaY, kernelY, inW, inH, segs);
    bandsFrom(bottom + 1, top - 1);
  }
  return segs;
}

// Separable conv on one segment rect — the sepFilter2D-on-a-non-isolated-
// ROI equivalent (VideoFrameTransform.cpp:189-197): border taps read real
// parent-plane pixels beyond the segment (across band/tile/eye seams),
// replicating only at true plane edges.  Float accumulate, half-up
// saturating round (the convention shared with the JAX pipeline).
// planeW/planeH are the full source plane dims for the global clamp.
static void filterSegment(const uint8_t* src, int stride, uint8_t* dst,
                          int dstride, int left, int top, int width,
                          int height, int planeW, int planeH,
                          const std::vector<float>& kx,
                          const std::vector<float>& ky,
                          std::vector<float>& tmp) {
  const int rx = ((int)kx.size() - 1) / 2;
  const int ry = ((int)ky.size() - 1) / 2;
  const int extH = height + 2 * ry;
  tmp.resize((size_t)width * extH);
  // horizontal pass over the vertically extended row range; reads clamp
  // at the full plane, not the segment
  for (int i2 = 0; i2 < extH; ++i2) {
    int si = std::min(std::max(top - ry + i2, 0), planeH - 1);
    const uint8_t* row = src + (size_t)si * stride;
    float* trow = tmp.data() + (size_t)i2 * width;
    for (int j = 0; j < width; ++j) {
      double acc = 0;
      for (int u = -rx; u <= rx; ++u) {
        int jj = std::min(std::max(left + j + u, 0), planeW - 1);
        acc += kx[u + rx] * row[jj];
      }
      trow[j] = (float)acc;
    }
  }
  // vertical pass
  for (int i = 0; i < height; ++i) {
    uint8_t* drow = dst + (size_t)(top + i) * dstride + left;
    for (int j = 0; j < width; ++j) {
      double acc = 0;
      for (int u = -ry; u <= ry; ++u) {
        acc += ky[u + ry] * tmp[(size_t)(i + u + ry) * width + j];
      }
      double r = std::floor(acc + 0.5);
      drow[j] = (uint8_t)std::min(255.0, std::max(0.0, r));
    }
  }
}

// ---------------------------------------------------------------------------
// Resampling (cv::remap semantics: 1/32-px fixed-point coordinates,
// BORDER_WRAP / transparent fill, OpenCV interpolation kernels)
// ---------------------------------------------------------------------------

static inline int wrapi(int v, int n) {
  v %= n;
  return v < 0 ? v + n : v;
}

// BORDER_REFLECT_101 (cv::remap's borderType1 fallback for partially-
// inside BORDER_TRANSPARENT footprints).  Loops like OpenCV's
// borderInterpolate so taps arbitrarily far out of range (8-tap lanczos
// on a plane narrower than 5 px) still land in [0, n).
static inline int reflect101i(int v, int n) {
  if (n == 1) return 0;
  while (v < 0 || v >= n) {
    if (v < 0) v = -v;
    else v = 2 * n - 2 - v;
  }
  return v;
}

static void cubicWeights(float f, float* w) {
  const float A = -0.75f;
  w[0] = ((A * (f + 1) - 5 * A) * (f + 1) + 8 * A) * (f + 1) - 4 * A;
  w[1] = ((A + 2) * f - (A + 3)) * f * f + 1;
  float g = 1.0f - f;
  w[2] = ((A + 2) * g - (A + 3)) * g * g + 1;
  w[3] = 1.0f - w[0] - w[1] - w[2];
}

static void lanczosWeights(float f, float* w) {
  if (f < 1e-7f) {
    for (int k = 0; k < 8; ++k) w[k] = 0;
    w[3] = 1;
    return;
  }
  static const double s45 = 0.70710678118654752440084436210485;
  static const double cs[8][2] = {{1, 0},  {-s45, -s45}, {0, 1},
                                  {s45, -s45}, {-1, 0},  {s45, s45},
                                  {0, -1}, {-s45, s45}};
  double y0 = -(f + 3.0) * kPi * 0.25;
  double s0 = std::sin(y0), c0 = std::cos(y0);
  double sum = 0;
  for (int k = 0; k < 8; ++k) {
    double y = -(f + 3.0 - k) * kPi * 0.25;
    w[k] = (float)((cs[k][0] * s0 + cs[k][1] * c0) / (y * y));
    sum += w[k];
  }
  for (int k = 0; k < 8; ++k) w[k] = (float)(w[k] / sum);
}

struct PlanePlanN {
  int inW = 0, inH = 0, outW = 0, outH = 0;      // final dims
  int scaledW = 0, scaledH = 0;                   // warp dims
  std::vector<int32_t> baseX, baseY;              // first-tap indices
  std::vector<float> fracX, fracY;                // 1/32-quantized fractions
  std::vector<uint8_t> valid;                     // transparent mask (may be empty)
  std::vector<Segment> segs;                      // prefilter raster
  bool wrap = true;
  int taps = 2, firstTap = 0;
};

static void remapPlane(const PlanePlanN& p, const uint8_t* src,
                       int sstride, uint8_t* dst, int dstride, int fill) {
  const int T = p.taps;
  const int H = p.inH, W = p.inW;
  std::vector<float> wx(8), wy(8);
  for (int i = 0; i < p.scaledH; ++i) {
    for (int j = 0; j < p.scaledW; ++j) {
      size_t q = (size_t)i * p.scaledW + j;
      if (!p.valid.empty() && !p.valid[q]) {
        dst[(size_t)i * dstride + j] = (uint8_t)fill;
        continue;
      }
      int bx = p.baseX[q], by = p.baseY[q];
      if (T == 1) {
        int xx = p.wrap ? wrapi(bx, W) : reflect101i(bx, W);
        int yy = p.wrap ? wrapi(by, H) : reflect101i(by, H);
        dst[(size_t)i * dstride + j] = src[(size_t)yy * sstride + xx];
        continue;
      }
      if (T == 2) {
        wx[0] = 1.0f - p.fracX[q];
        wx[1] = p.fracX[q];
        wy[0] = 1.0f - p.fracY[q];
        wy[1] = p.fracY[q];
      } else if (T == 4) {
        cubicWeights(p.fracX[q], wx.data());
        cubicWeights(p.fracY[q], wy.data());
      } else {
        lanczosWeights(p.fracX[q], wx.data());
        lanczosWeights(p.fracY[q], wy.data());
      }
      float acc = 0;
      for (int ty = 0; ty < T; ++ty) {
        int yy0 = by + ty;
        // non-wrap outside taps: fill for linear/cubic (cv::remap adds
        // the pre-filled dst value), REFLECT_101 for lanczos4
        bool yin = yy0 >= 0 && yy0 < H;
        int yy = p.wrap ? wrapi(yy0, H)
                        : (T == 8 ? reflect101i(yy0, H)
                                  : std::min(std::max(yy0, 0), H - 1));
        const uint8_t* row = src + (size_t)yy * sstride;
        float racc = 0;
        for (int tx = 0; tx < T; ++tx) {
          int xx0 = bx + tx;
          bool xin = xx0 >= 0 && xx0 < W;
          int xx = p.wrap ? wrapi(xx0, W)
                          : (T == 8 ? reflect101i(xx0, W)
                                    : std::min(std::max(xx0, 0), W - 1));
          float v = row[xx];
          if (!p.wrap && T != 8 && !(xin && yin)) v = (float)fill;
          racc += wx[tx] * v;
        }
        acc += wy[ty] * racc;
      }
      float r = std::floor(acc + 0.5f);
      dst[(size_t)i * dstride + j] =
          (uint8_t)std::min(255.0f, std::max(0.0f, r));
    }
  }
}

// INTER_AREA separable resize (downscale box integral / OpenCV-style
// enlargement coefficients), uint8 -> uint8.
static void areaResize(const uint8_t* src, int sw, int sh, int sstride,
                       uint8_t* dst, int dw, int dh, int dstride) {
  auto rowWeights = [](int nin, int nout) {
    std::vector<std::vector<std::pair<int, float>>> w(nout);
    if (nin >= nout) {
      double scale = (double)nin / nout;
      for (int i = 0; i < nout; ++i) {
        double lo = i * scale, hi = (i + 1) * scale;
        int j0 = (int)std::floor(lo), j1 = (int)std::ceil(hi);
        for (int j = j0; j < std::min(j1, nin); ++j) {
          double ww = std::min(hi, (double)j + 1) - std::max(lo, (double)j);
          w[i].push_back({j, (float)(ww / scale)});
        }
      }
    } else {
      double scale = (double)nin / nout, inv = (double)nout / nin;
      for (int i = 0; i < nout; ++i) {
        int j0 = (int)std::floor(i * scale);
        double f = (i + 1) - (j0 + 1) * inv;
        f = f <= 0 ? 0.0 : f - std::floor(f);
        if (j0 >= nin - 1) {
          w[i].push_back({nin - 1, 1.0f});
        } else {
          w[i].push_back({j0, (float)(1.0 - f)});
          w[i].push_back({j0 + 1, (float)f});
        }
      }
    }
    return w;
  };
  auto wr = rowWeights(sh, dh);
  auto wc = rowWeights(sw, dw);
  std::vector<float> tmp((size_t)dh * sw);
  for (int i = 0; i < dh; ++i) {
    for (int j = 0; j < sw; ++j) {
      float acc = 0;
      for (auto& [r, ww] : wr[i]) acc += ww * src[(size_t)r * sstride + j];
      tmp[(size_t)i * sw + j] = acc;
    }
  }
  for (int i = 0; i < dh; ++i) {
    for (int j = 0; j < dw; ++j) {
      float acc = 0;
      for (auto& [cidx, ww] : wc[j]) acc += ww * tmp[(size_t)i * sw + cidx];
      float r = std::floor(acc + 0.5f);
      dst[(size_t)i * dstride + j] =
          (uint8_t)std::min(255.0f, std::max(0.0f, r));
    }
  }
}

// ---------------------------------------------------------------------------
// Engine object (the VideoFrameTransform analog)
// ---------------------------------------------------------------------------

struct Engine {
  Ctx ctx;
  std::map<int, PlanePlanN> plans;
};

static bool generateMap(Engine* e, int inW, int inH, int outW, int outH,
                        int planeIdx) {
  const Ctx& c = e->ctx;
  if (inW <= 0 || inH <= 0 || outW <= 0 || outH <= 0) return false;
  if (c.num_vertical_segments < 2 || c.num_horizontal_segments < 1)
    return false;
  // GUESS must be resolved by the caller from frame aspect ratios (the
  // filter shell's job, vf_transform360.c:178-196); the geometry below
  // would otherwise treat it as a bogus stereo mode and silently build
  // a wrong map.
  if (c.input_stereo_format == S_GUESS || c.output_stereo_format == S_GUESS)
    return false;
  PlanePlanN p;
  p.inW = inW;
  p.inH = inH;
  p.outW = outW;
  p.outH = outH;
  p.scaledW = (int)(c.width_scale_factor * outW + 0.5f);
  p.scaledH = (int)(c.height_scale_factor * outH + 0.5f);
  float ipw = 1.0f / inW;
  if (c.input_stereo_format == S_LR) ipw *= 2;

  const bool barrel =
      c.output_layout == L_BARREL || c.output_layout == L_BARREL_SPLIT;
  p.wrap = !barrel;
  switch (c.interpolation_alg) {
    case I_NEAREST:
      p.taps = 1;
      p.firstTap = 0;
      break;
    case I_LINEAR:
      p.taps = 2;
      p.firstTap = 0;
      break;
    case I_CUBIC:
      p.taps = 4;
      p.firstTap = -1;
      break;
    case I_LANCZOS4:
      p.taps = 8;
      p.firstTap = -3;
      break;
    default:
      return false;
  }

  size_t n = (size_t)p.scaledW * p.scaledH;
  p.baseX.resize(n);
  p.baseY.resize(n);
  p.fracX.resize(n);
  p.fracY.resize(n);
  if (barrel) p.valid.resize(n);

  for (int i = 0; i < p.scaledH; ++i) {
    float y = (i + 0.5f) / p.scaledH;
    for (int j = 0; j < p.scaledW; ++j) {
      float x = (j + 0.5f) / p.scaledW;
      float ox, oy;
      if (!transformPos(c, x, y, &ox, &oy, ipw)) return false;
      double mx = (double)ox * inW - 0.5, my = (double)oy * inH - 0.5;
      size_t q = (size_t)i * p.scaledW + j;
      if (barrel) p.valid[q] = mx > -1.0 ? 1 : 0;
      if (p.taps == 1) {
        int32_t rx = (int32_t)std::nearbyint(mx);
        int32_t ry = (int32_t)std::nearbyint(my);
        p.baseX[q] = rx;
        p.baseY[q] = ry;
        p.fracX[q] = p.fracY[q] = 0;
        // BORDER_TRANSPARENT skip: untouched unless the rounded coord is
        // inside (remapNearest)
        if (barrel && (rx < 0 || rx > inW - 1 || ry < 0 || ry > inH - 1))
          p.valid[q] = 0;
      } else {
        // half-to-even like cvRound/np.rint so the 1/32 quantization
        // matches the Python plan and the OpenCV oracle bit-for-bit
        long sx = (long)std::nearbyint(mx * 32.0);
        long sy = (long)std::nearbyint(my * 32.0);
        long fx = sx >> 5, fy = sy >> 5;  // anchor (floor) coords
        p.baseX[q] = (int32_t)(fx + p.firstTap);
        p.baseY[q] = (int32_t)(fy + p.firstTap);
        p.fracX[q] = (sx & 31) / 32.0f;
        p.fracY[q] = (sy & 31) / 32.0f;
        if (barrel) {
          // BORDER_TRANSPARENT skip (measured against cv::remap, see
          // docs/parity.md): linear/cubic touch when floor is in
          // [-1, n-1] (any footprint overlap); lanczos4 needs [0, n-1]
          int lo = p.taps == 8 ? 0 : -1;
          if (fx < lo || fx > inW - 1 || fy < lo || fy > inH - 1)
            p.valid[q] = 0;
        }
      }
    }
  }

  if (c.enable_low_pass_filter)
    p.segs = filteringConfig(c, inW, inH, p.scaledW, p.scaledH);

  e->plans[planeIdx] = std::move(p);
  return true;
}

static void runFiltering(const Ctx& c, const PlanePlanN& p, const uint8_t* src,
                         int sstride, uint8_t* dst, int dstride, int W,
                         int H, bool allowThreads = true) {
  struct Job {
    int left, top;
    const Segment* s;
  };
  std::vector<Job> jobs;
  auto add = [&](int lo, int to) {
    for (auto& s : p.segs) jobs.push_back({s.left + lo, s.top + to, &s});
  };
  if (c.input_stereo_format == S_LR) {
    add(0, 0);
    add((int)(0.5 * W), 0);
  } else if (c.input_stereo_format == S_TB) {
    add(0, 0);
    add(0, (int)(0.5 * H));
  } else {
    add(0, 0);
  }
  // zero the destination first (parity with Mat::zeros init — uncovered
  // rows/cols for odd stereo dims stay zero)
  for (int i = 0; i < H; ++i) std::memset(dst + (size_t)i * dstride, 0, W);

  if (allowThreads && c.enable_multi_threading && jobs.size() > 1) {
    unsigned nthreads =
        std::min<unsigned>(std::thread::hardware_concurrency(),
                           (unsigned)jobs.size());
    std::atomic<size_t> next{0};
    std::vector<std::thread> pool;
    for (unsigned t = 0; t < nthreads; ++t) {
      pool.emplace_back([&]() {
        std::vector<float> tmp;
        size_t k;
        while ((k = next.fetch_add(1)) < jobs.size()) {
          const Job& j = jobs[k];
          filterSegment(src, sstride, dst, dstride, j.left, j.top,
                        j.s->width, j.s->height, W, H, j.s->kx, j.s->ky,
                        tmp);
        }
      });
    }
    for (auto& t : pool) t.join();
  } else {
    std::vector<float> tmp;
    for (auto& j : jobs)
      filterSegment(src, sstride, dst, dstride, j.left, j.top, j.s->width,
                    j.s->height, W, H, j.s->kx, j.s->ky, tmp);
  }
}

static bool transformFramePlane(Engine* e, const uint8_t* in, uint8_t* out,
                                int inW, int inH, int inStride, int outW,
                                int outH, int outStride, int planeIdx,
                                int imagePlaneIdx,
                                bool allowInnerThreads = true) {
  auto it = e->plans.find(planeIdx);
  if (it == e->plans.end()) return false;
  const PlanePlanN& p = it->second;
  if (p.inW != inW || p.inH != inH || p.outW != outW || p.outH != outH)
    return false;
  const Ctx& c = e->ctx;
  int fill = imagePlaneIdx ? 128 : 0;

  std::vector<uint8_t> blurred;
  const uint8_t* src = in;
  int sstride = inStride;
  if (c.enable_low_pass_filter && !p.segs.empty()) {
    blurred.resize((size_t)inW * inH);
    runFiltering(c, p, in, inStride, blurred.data(), inW, inW, inH,
                 allowInnerThreads);
    src = blurred.data();
    sstride = inW;
  }

  if (p.scaledW == outW && p.scaledH == outH) {
    remapPlane(p, src, sstride, out, outStride, fill);
  } else {
    std::vector<uint8_t> scaled((size_t)p.scaledW * p.scaledH,
                                (uint8_t)fill);
    remapPlane(p, src, sstride, scaled.data(), p.scaledW, fill);
    areaResize(scaled.data(), p.scaledW, p.scaledH, p.scaledW, out, outW,
               outH, outStride);
  }
  return true;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI (mirrors VideoFrameTransformHandler.h:24-47)
// ---------------------------------------------------------------------------

extern "C" {

void* T360_new(const Ctx* ctx) {
  auto* e = new (std::nothrow) Engine();
  if (!e) return nullptr;
  std::memcpy(&e->ctx, ctx, sizeof(Ctx));
  return e;
}

void T360_delete(void* h) { delete static_cast<Engine*>(h); }

int T360_generateMapForPlane(void* h, int inW, int inH, int outW, int outH,
                             int planeIdx) {
  return generateMap(static_cast<Engine*>(h), inW, inH, outW, outH, planeIdx)
             ? 1
             : 0;
}

int T360_transformFramePlane(void* h, const uint8_t* in, uint8_t* out,
                             int inW, int inH, int inStride, int outW,
                             int outH, int outStride, int planeIdx,
                             int imagePlaneIdx) {
  return transformFramePlane(static_cast<Engine*>(h), in, out, inW, inH,
                             inStride, outW, outH, outStride, planeIdx,
                             imagePlaneIdx)
             ? 1
             : 0;
}

// Frame-pool runner: transforms a contiguous batch of frames for one
// plane class across a worker pool — frame-level parallelism, the CPU
// analog of the TPU path's batch axis (the reference only parallelizes
// within one frame's prefilter, VideoFrameTransform.cpp:592-604).  Inner
// per-segment threading is disabled inside workers: one frame per worker
// keeps caches warm and avoids nested pools.  in/out are frame-major
// (frame i at in + i*inH*inStride / out + i*outH*outStride).  nThreads
// <= 0 means hardware concurrency.  Returns the number of frames
// transformed successfully (== nFrames on success).
int T360_transformFramesPlane(void* h, const uint8_t* in, uint8_t* out,
                              int nFrames, int inW, int inH, int inStride,
                              int outW, int outH, int outStride,
                              int planeIdx, int imagePlaneIdx,
                              int nThreads) {
  Engine* e = static_cast<Engine*>(h);
  if (nFrames <= 0) return 0;
  unsigned hw = std::thread::hardware_concurrency();
  unsigned nt = nThreads > 0 ? (unsigned)nThreads : (hw ? hw : 1);
  nt = std::min<unsigned>(nt, (unsigned)nFrames);
  std::atomic<size_t> next{0};
  std::atomic<int> ok{0};
  auto worker = [&]() {
    size_t k;
    while ((k = next.fetch_add(1)) < (size_t)nFrames) {
      const uint8_t* src = in + k * (size_t)inH * inStride;
      uint8_t* dst = out + k * (size_t)outH * outStride;
      if (transformFramePlane(e, src, dst, inW, inH, inStride, outW, outH,
                              outStride, planeIdx, imagePlaneIdx,
                              /*allowInnerThreads=*/nt == 1))
        ok.fetch_add(1);
    }
  };
  if (nt == 1) {
    worker();
  } else {
    std::vector<std::thread> pool;
    for (unsigned t = 0; t < nt; ++t) pool.emplace_back(worker);
    for (auto& t : pool) t.join();
  }
  return ok.load();
}

// Direct map export for cross-validation against the JAX geometry:
// writes scaledW*scaledH*2 floats (x,y interleaved, OpenCV pixel coords).
int T360_exportWarpMap(void* h, int planeIdx, float* outMap) {
  Engine* e = static_cast<Engine*>(h);
  auto it = e->plans.find(planeIdx);
  if (it == e->plans.end()) return 0;
  const PlanePlanN& p = it->second;
  // reconstruct quantized map coords (base - firstTap + frac)
  size_t n = (size_t)p.scaledW * p.scaledH;
  for (size_t q = 0; q < n; ++q) {
    outMap[2 * q] = (float)(p.baseX[q] - p.firstTap) + p.fracX[q];
    outMap[2 * q + 1] = (float)(p.baseY[q] - p.firstTap) + p.fracY[q];
  }
  return 1;
}

int T360_planeDims(void* h, int planeIdx, int* scaledW, int* scaledH) {
  Engine* e = static_cast<Engine*>(h);
  auto it = e->plans.find(planeIdx);
  if (it == e->plans.end()) return 0;
  *scaledW = it->second.scaledW;
  *scaledH = it->second.scaledH;
  return 1;
}

}  // extern "C"
