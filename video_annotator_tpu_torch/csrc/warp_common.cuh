// Helpers that K1's two sources share (csrc/warp.cu: the bilinear,
// rectilinear-output kernels; csrc/warp_modes.cu: the 4-tap, ray-grid and
// per-tile mip modes): the camera parameters, the per-tile-row rotation,
// the unfused products and sums, the input camera's projection, the
// rounding to bytes, and the grouped design's parts (the group width, the
// row's shared products, the 2x2 taps with 32-bit offsets, the uint8
// group's word stores). Everything here is inlined into each kernel.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct WarpParams {
  float inv_ofx, inv_ofy, ocx, ocy;  // output (rectilinear) camera, 1 / focal
  float ifx, ify, icx, icy;  // input camera
  float k1, k2, k3, k4;      // input fisheye distortion
  float border;
  int in_w, in_h, out_w, out_h;
  int fisheye;
};

constexpr int TILE_ROWS = 8;  // output rows per 3x3 with ny > 0, = blockDim.y

// The 3x3 of this block's rows of frame t: rot is (T, 3, 3) without RS and
// (T, ny, 3, 3) with it, a block being one tile row and its index clipped
// to the stack. A run-time test of ny here instead of the template
// argument cost the whole-frame launches 2 to 7% on an H100, and a 64-bit
// t * 9 another 2% on the 4K luma batch (tools/time_warp_builds.py).
template <bool RS>
__device__ __forceinline__ const float* row_rotation(int ny, const float* __restrict__ rot,
                                                     int t) {
  if (!RS) return rot + t * 9;
  return rot + ((size_t)t * ny + min((int)blockIdx.y, ny - 1)) * 9;
}

// Products and sums that the compiler may not contract into fused
// multiply-adds. The plain version computes the map and the taps as
// separate float32 tensor operations, each rounded; with the same roundings
// here the source coordinates agree bit for bit on the card (both sides use
// CUDA's division, sqrtf and atanf). A contracted map differs by about
// 1e-3 px at 4K, which the image gradient turns into a tenth of a count:
// too coarse a tolerance to hold a float kernel to.
__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }

// The rotated ray v through the input camera: a = vx/vz, b = vy/vz, then
// the fisheye model or the pinhole.
__device__ __forceinline__ void input_coords(const WarpParams& p, float vx, float vy,
                                             float vz, float* sx, float* sy) {
  const float inv_z = 1.0f / vz;
  const float a = vx * inv_z;
  const float b = vy * inv_z;
  if (p.fisheye) {
    const float rr = sqrtf(add(mul(a, a), mul(b, b)));
    const float th = atanf(rr);
    const float t2 = th * th;
    const float poly = add(p.k1, mul(t2, add(p.k2, mul(t2, add(p.k3, mul(t2, p.k4))))));
    const float thd = mul(th, add(1.0f, mul(t2, poly)));
    const float scale = rr > 1e-8f ? thd / fmaxf(rr, 1e-8f) : 1.0f;
    *sx = add(mul(mul(p.ifx, a), scale), p.icx);
    *sy = add(mul(mul(p.ify, b), scale), p.icy);
  } else {
    *sx = add(mul(p.ifx, a), p.icx);
    *sy = add(mul(p.ify, b), p.icy);
  }
}

__device__ __forceinline__ uint8_t to_u8(float v) {
  return (uint8_t)(int)fminf(fmaxf(rintf(v), 0.0f), 255.0f);
}

// Output columns of one row a thread renders, sharing its index math,
// bounds test, frame and plane bases, 3x3 fetch and row products. The
// uint8 kernel's are consecutive and leave in one word store per plane:
// on an H100 at the 4K shapes 8 took its 32-frame luma launch to 0.97 of
// 4 and its chroma launch to 1.04 of 4; 2 was slower for both. The float
// and mode kernels' lie 32 apart (lane + 32 j), so that each load and
// store of a warp covers 32 consecutive pixels: consecutive columns with
// float4 stores took the float luma launch to 1.05 of that, and the mode
// kernel's 4-tap launches to 1.3-3.4 of the one-pixel-a-thread kernel; 4
// columns for one plane and 8 for more were slower for the float kernels
// (1.01-1.06) and mixed for the modes (tools/time_warp_builds.py).
__host__ __device__ constexpr int group_of(int nplanes) { return nplanes == 1 ? 8 : 4; }
template <int NPLANES>
constexpr int GROUP = group_of(NPLANES);

// The grouped kernels' grid: a 32x8 block per 32 * group columns of one
// 8-row tile row (so a block row stays one `rs` tile row), `z` blocks deep.
inline dim3 group_grid(int z, int group, int rows, int out_w) {
  const int cols = 32 * group;
  return dim3((out_w + cols - 1) / cols, (rows + TILE_ROWS - 1) / TILE_ROWS, z);
}

// Whether the taps of a plane of `rows` rows, `pitch` elements `item`
// bytes each apart, fit 32-bit offsets: the rows one past the plane
// included, counted in bytes.
inline bool plane_fits(int rows, int pitch, int item) {
  return (long long)(rows + 1) * pitch * item < (1LL << 31);
}

// The source coordinates of the pixels of one output row of a
// rectilinear output camera: the row's products r[1] ry, r[4] ry, r[7] ry
// taken once. Every value is the one the one-pixel-a-thread map rounded
// (the same unfused products and sums in the same order), so the
// coordinates agree bit for bit. The bounds tests are the caller's.
struct RowMap {
  float r0, r2, r3, r5, r6, r8;
  float a1, a4, a7;  // r[1] ry, r[4] ry, r[7] ry

  __device__ __forceinline__ RowMap(const WarpParams& p, const float* __restrict__ r, int y) {
    const float ry = mul((float)y - p.ocy, p.inv_ofy);
    r0 = r[0], r2 = r[2], r3 = r[3], r5 = r[5], r6 = r[6], r8 = r[8];
    a1 = mul(r[1], ry), a4 = mul(r[4], ry), a7 = mul(r[7], ry);
  }

  // xf: the column as a float, (float)x. True where the ray points ahead
  // of the camera.
  __device__ __forceinline__ bool coords(const WarpParams& p, float xf, float* sx,
                                         float* sy) const {
    const float rx = mul(xf - p.ocx, p.inv_ofx);
    const float vx = add(add(mul(r0, rx), a1), r2);
    const float vy = add(add(mul(r3, rx), a4), r5);
    const float vz = add(add(mul(r6, rx), a7), r8);
    input_coords(p, vx, vy, vz, sx, sy);
    return vz > 1e-6f;
  }
};

// The exact 2x2 bilinear taps of one uint8 or float plane at (sx, sy),
// centred on the border (out-of-image taps contribute 0, the sum gets
// + border), with 32-bit offsets inside the plane (the host refuses a
// plane that does not fit, plane_fits). The caller tells an interior
// pixel, whose four taps all lie in the image, from its coordinates:
// floor(sx) >= 0 and floor(sx) + 1 < in_w are sx >= 0 and sx < in_w - 1.
// Its taps are read without predicates (interior), the others' each
// behind its own test (edge). Both give the one-pixel-a-thread kernels'
// bits.
struct PixelTaps {
  float fx, fy;
  int xi, yi;
  int off;  // yi * in_w + xi

  __device__ __forceinline__ PixelTaps(const WarpParams& p, float sx, float sy) {
    const float x0 = floorf(sx);
    const float y0 = floorf(sy);
    fx = sx - x0;
    fy = sy - y0;
    xi = (int)x0;
    yi = (int)y0;
    off = yi * p.in_w + xi;
  }

  template <typename T>
  __device__ __forceinline__ float interior(const T* __restrict__ s, int in_w,
                                            float border) const {
    const T* q = s + off;
    return blend((float)__ldg(q) - border, (float)__ldg(q + 1) - border,
                 (float)__ldg(q + in_w) - border, (float)__ldg(q + in_w + 1) - border, border);
  }

  template <typename T>
  __device__ __forceinline__ float edge(const WarpParams& p, const T* __restrict__ s,
                                        float border) const {
    const bool in_x0 = xi >= 0, in_x1 = xi + 1 < p.in_w;
    const bool in_y0 = yi >= 0, in_y1 = yi + 1 < p.in_h;
    const T* q = s + off;
    const float v00 = (in_y0 && in_x0) ? (float)__ldg(q) - border : 0.0f;
    const float v01 = (in_y0 && in_x1) ? (float)__ldg(q + 1) - border : 0.0f;
    const float v10 = (in_y1 && in_x0) ? (float)__ldg(q + p.in_w) - border : 0.0f;
    const float v11 = (in_y1 && in_x1) ? (float)__ldg(q + p.in_w + 1) - border : 0.0f;
    return blend(v00, v01, v10, v11, border);
  }

  // A flat plane of `value` that is never read (the diagnostic NO_TAPS).
  __device__ __forceinline__ float flat(const WarpParams& p, float value, float border) const {
    const bool in_x0 = xi >= 0, in_x1 = xi + 1 < p.in_w;
    const bool in_y0 = yi >= 0, in_y1 = yi + 1 < p.in_h;
    const float v = value - border;
    return blend((in_y0 && in_x0) ? v : 0.0f, (in_y0 && in_x1) ? v : 0.0f,
                 (in_y1 && in_x0) ? v : 0.0f, (in_y1 && in_x1) ? v : 0.0f, border);
  }

  __device__ __forceinline__ float blend(float v00, float v01, float v10, float v11,
                                         float border) const {
    return blend2(fx, fy, v00, v01, v10, v11, border);
  }

  // The blend of four border-centred taps at fractions (fx, fy).
  static __device__ __forceinline__ float blend2(float fx, float fy, float v00, float v01,
                                                 float v10, float v11, float border) {
    const float top = add(mul(v00, 1.0f - fx), mul(v01, fx));
    const float bot = add(mul(v10, 1.0f - fx), mul(v11, fx));
    return add(add(mul(top, 1.0f - fy), mul(bot, fy)), border);
  }
};

// The n <= G bytes of b to o: 32-bit words where the whole group is in
// the row and o is aligned, else byte by byte.
template <int G>
__device__ __forceinline__ void store_group(uint8_t* o, const uint8_t (&b)[G], int n,
                                            bool aligned) {
  static_assert(G % 4 == 0, "a group is whole 32-bit words");
  if (n == G && aligned) {
#pragma unroll
    for (int w = 0; w < G / 4; ++w) {
      reinterpret_cast<uint32_t*>(o)[w] =
          (uint32_t)b[4 * w] | ((uint32_t)b[4 * w + 1] << 8) |
          ((uint32_t)b[4 * w + 2] << 16) | ((uint32_t)b[4 * w + 3] << 24);
    }
    return;
  }
#pragma unroll
  for (int j = 0; j < G; ++j)
    if (j < n) o[j] = b[j];
}

}  // namespace
