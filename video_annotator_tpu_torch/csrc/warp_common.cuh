// Helpers that K1's two sources share (csrc/warp.cu: the bilinear,
// rectilinear-output kernels; csrc/warp_modes.cu: the 4-tap, ray-grid and
// per-tile mip modes): the camera parameters, the per-tile-row rotation,
// the unfused products and sums, the input camera's projection and the
// rounding to bytes. Everything here is inlined into each kernel.

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

}  // namespace
