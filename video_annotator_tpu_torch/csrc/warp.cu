// K1: fused warp map + bilinear remap of a frame batch to uint8.
//
// Replaces the TPU fused warp video_annotator_tpu/ops/warp_pallas.py
// (_make_kernel :923-1499 as built by _build_warp_yuv_batch_fn :2141: the
// uint8 luma kernel call_y and the two-plane chroma kernel call_c,
// batched="uv", border=128). Per output pixel of a rectilinear output
// camera: ray = ((x-ocx)/ofx, (y-ocy)/ofy, 1), v = R ray, a = vx/vz,
// b = vy/vz; for a fisheye input theta = atan(r)(1+k1 t^2+..+k4 t^8),
// s = theta/r; then exact 2x2 bilinear sampling with out-of-image taps
// reading `border`, round half to even (rintf) and clamp to uint8. The
// sampling is centred on the border value like the XLA oracle
// (video_annotator_tpu/pipeline/render.py:1806-1812): taps contribute
// (p - border), the sum gets + border.
//
// Bound on Hopper: the dependent 4-tap gather of uint8 source bytes and
// the output stores; the map (about 40 flops and one atanf per pixel) is
// cheap next to them. Design: one thread per output pixel, a 32x8 block
// so a warp covers 32 consecutive output columns (coalesced stores, taps
// of neighbouring pixels hit the same source cache lines), the source
// read straight from global memory through the read-only cache. In the
// chroma mode one thread computes the map once and samples both planes.
// No VMEM windows, origin passes or packed layouts: those served the
// TPU's lane gather.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

struct WarpParams {
  float ofx, ofy, ocx, ocy;  // output (rectilinear) camera
  float ifx, ify, icx, icy;  // input camera
  float k1, k2, k3, k4;      // input fisheye distortion
  float border;
  int in_w, in_h, out_w, out_h;
  int fisheye;
};

template <int NPLANES>
__global__ void warp_kernel(const uint8_t* __restrict__ src,
                            uint8_t* __restrict__ dst,
                            const float* __restrict__ rot, WarpParams p) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int t = blockIdx.z;
  if (x >= p.out_w || y >= p.out_h) return;

  const float* r = rot + t * 9;
  const float rx = ((float)x - p.ocx) / p.ofx;
  const float ry = ((float)y - p.ocy) / p.ofy;
  const float vx = r[0] * rx + r[1] * ry + r[2];
  const float vy = r[3] * rx + r[4] * ry + r[5];
  const float vz = r[6] * rx + r[7] * ry + r[8];
  const float inv_z = 1.0f / vz;
  const float a = vx * inv_z;
  const float b = vy * inv_z;
  float sx, sy;
  if (p.fisheye) {
    const float rr = sqrtf(a * a + b * b);
    const float th = atanf(rr);
    const float t2 = th * th;
    const float thd = th * (1.0f + t2 * (p.k1 + t2 * (p.k2 + t2 * (p.k3 + t2 * p.k4))));
    const float scale = rr > 1e-8f ? thd / fmaxf(rr, 1e-8f) : 1.0f;
    sx = p.ifx * a * scale + p.icx;
    sy = p.ify * b * scale + p.icy;
  } else {
    sx = p.ifx * a + p.icx;
    sy = p.ify * b + p.icy;
  }

  const size_t in_plane = (size_t)p.in_h * p.in_w;
  const size_t out_plane = (size_t)p.out_h * p.out_w;
  uint8_t* out = dst + (size_t)t * NPLANES * out_plane + (size_t)y * p.out_w + x;
  // Every tap outside the image (or a ray behind the camera): the border.
  const bool valid = sx > -1.0f && sx < (float)p.in_w && sy > -1.0f &&
                     sy < (float)p.in_h && vz > 1e-6f;
  if (!valid) {
    const uint8_t bu8 = (uint8_t)(int)fminf(fmaxf(rintf(p.border), 0.0f), 255.0f);
#pragma unroll
    for (int pl = 0; pl < NPLANES; ++pl) out[pl * out_plane] = bu8;
    return;
  }
  const float x0 = floorf(sx);
  const float y0 = floorf(sy);
  const float fx = sx - x0;
  const float fy = sy - y0;
  const int xi = (int)x0;
  const int yi = (int)y0;
  const bool in_x0 = xi >= 0, in_x1 = xi + 1 < p.in_w;
  const bool in_y0 = yi >= 0, in_y1 = yi + 1 < p.in_h;
  const size_t row0 = (size_t)yi * p.in_w;
  const size_t row1 = row0 + p.in_w;
#pragma unroll
  for (int pl = 0; pl < NPLANES; ++pl) {
    const uint8_t* s = src + ((size_t)t * NPLANES + pl) * in_plane;
    const float v00 = (in_y0 && in_x0) ? (float)__ldg(s + row0 + xi) - p.border : 0.0f;
    const float v01 = (in_y0 && in_x1) ? (float)__ldg(s + row0 + xi + 1) - p.border : 0.0f;
    const float v10 = (in_y1 && in_x0) ? (float)__ldg(s + row1 + xi) - p.border : 0.0f;
    const float v11 = (in_y1 && in_x1) ? (float)__ldg(s + row1 + xi + 1) - p.border : 0.0f;
    const float top = v00 * (1.0f - fx) + v01 * fx;
    const float bot = v10 * (1.0f - fx) + v11 * fx;
    const float val = top * (1.0f - fy) + bot * fy + p.border;
    out[pl * out_plane] = (uint8_t)(int)fminf(fmaxf(rintf(val), 0.0f), 255.0f);
  }
}

}  // namespace

extern "C" int vat_warp_u8(const void* src, void* dst, const void* rot, int t,
                           int nplanes, int in_h, int in_w, int out_h, int out_w,
                           float ofx, float ofy, float ocx, float ocy, float ifx,
                           float ify, float icx, float icy, float k1, float k2,
                           float k3, float k4, int fisheye, float border,
                           void* stream) {
  WarpParams p{ofx, ofy, ocx, ocy, ifx, ify, icx, icy, k1, k2, k3, k4,
               border, in_w, in_h, out_w, out_h, fisheye};
  const dim3 block(32, 8);
  const dim3 grid((out_w + 31) / 32, (out_h + 7) / 8, t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* in = static_cast<const uint8_t*>(src);
  uint8_t* out = static_cast<uint8_t*>(dst);
  const float* r = static_cast<const float*>(rot);
  if (nplanes == 1) {
    warp_kernel<1><<<grid, block, 0, s>>>(in, out, r, p);
  } else if (nplanes == 2) {
    warp_kernel<2><<<grid, block, 0, s>>>(in, out, r, p);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
