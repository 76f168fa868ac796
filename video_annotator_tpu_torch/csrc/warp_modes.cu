// K1's modes beyond the bilinear, rectilinear-output warp of csrc/warp.cu:
// the 4-tap resamplers, the ray grid and the per-tile mip prefilter, each
// in the uint8 and float modes, one 3x3 per frame or per tile row.
//
// Replaces the variants of the TPU fused warp
// video_annotator_tpu/ops/warp_pallas.py::_make_kernel (:923-1499) that
// its builders (_build_warp_yuv_batch_fn :2141, _build_warp_yuv_fn :2041,
// _build_warp_fn :1803, _build_warp_planes_fn :1957) compile from a plan:
//   4 taps     plan.taps == 4 (:956, :1196, :1223-1236, :1256-1258):
//              bicubic (Keys, a = -0.75) or lanczos (a = 2, normalised by
//              the separable weight sums) over the 4x4 taps at -1..2
//              around the floor. The TPU fitted polynomials to the
//              weights; here the true weights are evaluated once per pixel
//              and shared by its planes, as the XLA oracle evaluates them.
//              A pixel up to one more pixel outside the image still has
//              taps inside, so the rendered band is one pixel wider.
//   ray grid   an output camera that is not rectilinear (ray_grid :950,
//              :1154-1161): the output rays are a (3, out_h, out_w)
//              float32 tensor computed once per camera by the port's own
//              Camera.unproject, and v = R g is formed here in the plain
//              version's order (ops/warp_plain.py::compute_warp_map).
//   mip        plan.mip_max (:1031-1035, :1203-1210 with
//              pack_frame_words_mip :1711): a (ceil(out_h/8),
//              ceil(out_w/128)) uint8 level map; a pixel is rendered or
//              not by its full-resolution coordinates, and a pixel of a
//              level-l tile samples level l (l = 1, 2: box_downsample^l of
//              the plane, staged to bytes by K3 in the uint8 mode, float in
//              the float mode) at (s + 0.5) 2^-l - 0.5, taps outside the
//              level reading the border.
// The interpolation is a template argument; the ray grid and the level map
// are pointers, null when the mode is off, tested uniformly by every
// thread. The bilinear, rectilinear, whole-map kernels of csrc/warp.cu are
// untouched by these modes.
//
// The same modes serve the float frame batch of _build_warp_batch_fn
// (:1860, row 6: t > 1 float frames, one plane each, one 3x3 per frame,
// the frame at blockIdx.z as in the uint8 mode) and the band of
// _build_warp_band_fn (:2303, row 9): a template argument BAND maps block
// row b to global tile row min(b + off, ny - 1) of the frame, whose
// out_h is then the padded ny * 8 rows the ray grid has; every other
// instantiation computes what it computed before.
//
// Every product and sum runs unfused in the order of the plain version
// (ops/warp_plain.py, ops/mip.py), so the two agree bit for bit on the
// card; lanczos uses sinf, as torch.sin does there.
//
// Bound on Hopper: by operations. Per output pixel a 4-tap launch adds the
// eight weights (bicubic about 10 operations each, lanczos two sinf, a
// division and about 8 more each) and per plane 16 loads and 32 operations,
// against bilinear's 4 loads and 20; a ray grid adds 12 bytes read per
// pixel and 3 operations; a mip level adds 6 operations and its stacks.
// Design as in csrc/warp.cu: one thread per output pixel, a 32x8 block (one
// tile row of the level map, a quarter of a level tile's width), the
// sources read through the read-only cache.

#include <type_traits>

#include "warp_common.cuh"

namespace {

constexpr int MAX_LEVELS = 3;   // the plane and mip levels 1..ops/mip.py's MIP_LEVELS
constexpr int TILE_COLS = 128;  // output columns per entry of the level map

enum Interp { BILINEAR = 0, BICUBIC = 1, LANCZOS = 2 };

// One level of the source: plane (t * NPLANES + pl) starts at
// base + (t * NPLANES + pl) * plane, rows `pitch` elements apart.
struct Level {
  const void* base;
  long long plane;
  int pitch, h, w;
};

struct Modes {
  const float* rays;      // (3, out_h, out_w), or null: rectilinear output
  const uint8_t* levels;  // (ceil(out_h / 8), levels_nx), or null: no mip
  int levels_nx;
  Level level[MAX_LEVELS];
  int band_ny, band_off;  // BAND: the frame's tile rows, the band's first
};

__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

template <typename T>
__device__ __forceinline__ float load(const void* base, size_t i) {
  return (float)__ldg(static_cast<const T*>(base) + i);
}

__device__ __forceinline__ void store(uint8_t* p, float v) { *p = to_u8(v); }
__device__ __forceinline__ void store(float* p, float v) { *p = v; }

// warp_plain.keys_weight, a = -0.75
__device__ __forceinline__ float keys(float t) {
  t = fabsf(t);
  const float near = add(mul(mul(sub(mul(1.25f, t), 2.25f), t), t), 1.0f);
  const float far = mul(-0.75f, sub(mul(add(mul(sub(t, 5.0f), t), 8.0f), t), 4.0f));
  return t <= 1.0f ? near : (t < 2.0f ? far : 0.0f);
}

// warp_plain.lanczos_weight, a = 2: sin(pi t) sin(pi t / 2) 2 / (pi t)^2
__device__ __forceinline__ float lanczos(float t) {
  t = fabsf(t);
  const float pt = mul(3.14159265358979323846f, fmaxf(t, 1e-6f));
  const float win =
      mul(mul(sinf(pt), sinf(mul(pt, 0.5f))), mul(__fdiv_rn(1.0f, mul(pt, pt)), 2.0f));
  return t < 1e-6f ? 1.0f : (t < 2.0f ? win : 0.0f);
}

template <int INTERP>
__device__ __forceinline__ float weight(float t) {
  return INTERP == BICUBIC ? keys(t) : lanczos(t);
}

__device__ __forceinline__ Level pick(const Modes& m, int l) {
  return l == 0 ? m.level[0] : (l == 1 ? m.level[1] : m.level[2]);
}

// Exact 2x2 bilinear taps of one plane of `lv`, centred on the border.
template <typename T>
__device__ __forceinline__ float sample2(const Level& lv, size_t plane, float sx, float sy,
                                         float border) {
  const float x0 = floorf(sx);
  const float y0 = floorf(sy);
  const float fx = sx - x0;
  const float fy = sy - y0;
  const int xi = (int)x0;
  const int yi = (int)y0;
  const bool in_x0 = xi >= 0 && xi < lv.w, in_x1 = xi + 1 >= 0 && xi + 1 < lv.w;
  const bool in_y0 = yi >= 0 && yi < lv.h, in_y1 = yi + 1 >= 0 && yi + 1 < lv.h;
  const size_t row0 = plane + (size_t)((long long)yi * lv.pitch);
  const size_t row1 = row0 + lv.pitch;
  const float v00 = (in_y0 && in_x0) ? load<T>(lv.base, row0 + xi) - border : 0.0f;
  const float v01 = (in_y0 && in_x1) ? load<T>(lv.base, row0 + xi + 1) - border : 0.0f;
  const float v10 = (in_y1 && in_x0) ? load<T>(lv.base, row1 + xi) - border : 0.0f;
  const float v11 = (in_y1 && in_x1) ? load<T>(lv.base, row1 + xi + 1) - border : 0.0f;
  const float top = add(mul(v00, 1.0f - fx), mul(v01, fx));
  const float bot = add(mul(v10, 1.0f - fx), mul(v11, fx));
  return add(add(mul(top, 1.0f - fy), mul(bot, fy)), border);
}

// The 4x4 taps at -1..2 around (xi, yi) of one plane of `lv`, weighted by
// wx (columns) and wy (rows): each row summed left to right, the rows top
// to bottom; lanczos divides by `norm`.
template <typename T, int INTERP>
__device__ __forceinline__ float sample4(const Level& lv, size_t plane, int xi, int yi,
                                         const float* wx, const float* wy, float norm,
                                         float border) {
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int yy = yi - 1 + j;
    const bool in_y = yy >= 0 && yy < lv.h;
    const size_t row = plane + (size_t)((long long)yy * lv.pitch);
    float line = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int xx = xi - 1 + k;
      const float v = (in_y && xx >= 0 && xx < lv.w) ? load<T>(lv.base, row + xx) - border : 0.0f;
      const float term = mul(wx[k], v);
      line = k == 0 ? term : add(line, term);
    }
    const float term = mul(wy[j], line);
    acc = j == 0 ? term : add(acc, term);
  }
  if constexpr (INTERP == LANCZOS) acc = __fdiv_rn(acc, norm);
  return add(acc, border);
}

// (T, NPLANES, in_h, in_w) planes (level 0 of `m`) -> (T, NPLANES, out_h,
// out_w) of type T: uint8 rounded half to even and clamped, or float32 as
// it is. One 3x3 per frame, or per tile row with RS. With BAND, one frame
// to (gridDim.y * 8, out_w): output row yo holds global row y.
template <typename T, int NPLANES, bool RS, int INTERP, bool BAND = false>
__global__ void warp_modes_kernel(T* __restrict__ dst, const float* __restrict__ rot,
                                  WarpParams p, int ny, Modes m) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int yo = blockIdx.y * blockDim.y + threadIdx.y;
  const int t = blockIdx.z;
  int y = yo;
  if constexpr (BAND) {
    y = min((int)blockIdx.y + m.band_off, m.band_ny - 1) * TILE_ROWS + (int)threadIdx.y;
    if (x >= p.out_w) return;
  } else {
    if (x >= p.out_w || y >= p.out_h) return;
  }

  const float* r = row_rotation<RS>(ny, rot, t);
  float vx, vy, vz;
  if (m.rays != nullptr) {
    const size_t n = (size_t)p.out_h * p.out_w;
    const size_t i = (size_t)y * p.out_w + x;
    const float gx = __ldg(m.rays + i);
    const float gy = __ldg(m.rays + n + i);
    const float gz = __ldg(m.rays + 2 * n + i);
    vx = add(add(mul(r[0], gx), mul(r[1], gy)), mul(r[2], gz));
    vy = add(add(mul(r[3], gx), mul(r[4], gy)), mul(r[5], gz));
    vz = add(add(mul(r[6], gx), mul(r[7], gy)), mul(r[8], gz));
  } else {
    const float rx = mul((float)x - p.ocx, p.inv_ofx);
    const float ry = mul((float)y - p.ocy, p.inv_ofy);
    vx = add(add(mul(r[0], rx), mul(r[1], ry)), r[2]);
    vy = add(add(mul(r[3], rx), mul(r[4], ry)), r[5]);
    vz = add(add(mul(r[6], rx), mul(r[7], ry)), r[8]);
  }
  float sx, sy;
  input_coords(p, vx, vy, vz, &sx, &sy);
  constexpr float PAD = INTERP == BILINEAR ? 0.0f : 1.0f;
  const bool valid = sx > -1.0f - PAD && sx < (float)p.in_w + PAD && sy > -1.0f - PAD &&
                     sy < (float)p.in_h + PAD && vz > 1e-6f;

  const size_t out_plane = (size_t)p.out_h * p.out_w;
  T* out = dst + (size_t)t * NPLANES * out_plane + (size_t)yo * p.out_w + x;
  if (!valid) {
#pragma unroll
    for (int pl = 0; pl < NPLANES; ++pl) store(out + pl * out_plane, p.border);
    return;
  }
  int l = 0;
  if (m.levels != nullptr) l = m.levels[(size_t)blockIdx.y * m.levels_nx + x / TILE_COLS];
  if (l > 0) {
    const float s = l == 1 ? 0.5f : 0.25f;
    sx = sub(mul(add(sx, 0.5f), s), 0.5f);
    sy = sub(mul(add(sy, 0.5f), s), 0.5f);
  }
  const Level lv = pick(m, l);

  float wx[4], wy[4], norm = 1.0f;
  int xi = 0, yi = 0;
  if constexpr (INTERP != BILINEAR) {
    const float x0 = floorf(sx);
    const float y0 = floorf(sy);
    const float fx = sx - x0;
    const float fy = sy - y0;
    xi = (int)x0;
    yi = (int)y0;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wx[k] = weight<INTERP>(sub(fx, (float)(k - 1)));
      wy[k] = weight<INTERP>(sub(fy, (float)(k - 1)));
    }
    if constexpr (INTERP == LANCZOS) {
      norm = mul(add(add(add(wx[0], wx[1]), wx[2]), wx[3]),
                 add(add(add(wy[0], wy[1]), wy[2]), wy[3]));
    }
  }
#pragma unroll
  for (int pl = 0; pl < NPLANES; ++pl) {
    const size_t plane = (size_t)((long long)(t * NPLANES + pl) * lv.plane);
    if constexpr (INTERP == BILINEAR) {
      store(out + pl * out_plane, sample2<T>(lv, plane, sx, sy, p.border));
    } else {
      store(out + pl * out_plane,
            sample4<T, INTERP>(lv, plane, xi, yi, wx, wy, norm, p.border));
    }
  }
}

template <typename T, int NPLANES, bool RS>
bool launch_interp(int interp, dim3 grid, dim3 block, cudaStream_t s, T* out, const float* r,
                   const WarpParams& p, int ny, const Modes& m) {
  switch (interp) {
    case BILINEAR:
      warp_modes_kernel<T, NPLANES, RS, BILINEAR><<<grid, block, 0, s>>>(out, r, p, ny, m);
      return true;
    case BICUBIC:
      warp_modes_kernel<T, NPLANES, RS, BICUBIC><<<grid, block, 0, s>>>(out, r, p, ny, m);
      return true;
    case LANCZOS:
      warp_modes_kernel<T, NPLANES, RS, LANCZOS><<<grid, block, 0, s>>>(out, r, p, ny, m);
      return true;
    default:
      return false;
  }
}

// uint8 takes 1 or 2 planes (luma, chroma), float up to 4.
template <typename T, bool RS>
bool launch_planes(int nplanes, int interp, dim3 grid, dim3 block, cudaStream_t s, T* out,
                   const float* r, const WarpParams& p, int ny, const Modes& m) {
  switch (nplanes) {
    case 1: return launch_interp<T, 1, RS>(interp, grid, block, s, out, r, p, ny, m);
    case 2: return launch_interp<T, 2, RS>(interp, grid, block, s, out, r, p, ny, m);
    default: break;
  }
  if constexpr (std::is_same<T, float>::value) {
    switch (nplanes) {
      case 3: return launch_interp<T, 3, RS>(interp, grid, block, s, out, r, p, ny, m);
      case 4: return launch_interp<T, 4, RS>(interp, grid, block, s, out, r, p, ny, m);
      default: break;
    }
  }
  return false;
}

// The band: one float plane, one 3x3, no mip; band_rows block rows.
bool launch_band(int interp, int band_rows, cudaStream_t s, void* dst, const float* r,
                 const WarpParams& p, const Modes& m) {
  const dim3 block(32, TILE_ROWS);
  const dim3 grid((p.out_w + 31) / 32, band_rows, 1);
  float* out = static_cast<float*>(dst);
  switch (interp) {
    case BILINEAR:
      warp_modes_kernel<float, 1, false, BILINEAR, true><<<grid, block, 0, s>>>(out, r, p, 0, m);
      return true;
    case BICUBIC:
      warp_modes_kernel<float, 1, false, BICUBIC, true><<<grid, block, 0, s>>>(out, r, p, 0, m);
      return true;
    case LANCZOS:
      warp_modes_kernel<float, 1, false, LANCZOS, true><<<grid, block, 0, s>>>(out, r, p, 0, m);
      return true;
    default:
      return false;
  }
}

template <typename T>
bool launch(int nplanes, int interp, int t, int ny, cudaStream_t s, void* dst,
            const float* r, const WarpParams& p, const Modes& m) {
  const dim3 block(32, TILE_ROWS);
  const dim3 grid((p.out_w + 31) / 32, (p.out_h + TILE_ROWS - 1) / TILE_ROWS, t);
  T* out = static_cast<T*>(dst);
  return ny > 0 ? launch_planes<T, true>(nplanes, interp, grid, block, s, out, r, p, ny, m)
                : launch_planes<T, false>(nplanes, interp, grid, block, s, out, r, p, ny, m);
}

}  // namespace

// `f32`: float32 planes in and out, else uint8; t > 1 float frames take
// one plane each. `interp`: 0 bilinear, 1 bicubic, 2 lanczos. `rays`: null
// for a rectilinear output. `levels`: null without mip; levels 1 and 2 as
// (base, elements between planes, row pitch, rows, columns), a null base
// for a level the map never names. `band_rows` > 0: the band of one float
// plane, tile rows [band_off, band_off + band_rows) of the frame's
// ceil(out_h / 8), out_h the ray grid's padded rows.
extern "C" int vat_warp_modes(int f32, const void* src, void* dst, const void* rot, int t,
                              int nplanes, int in_h, int in_w, int out_h, int out_w, int ny,
                              float ofx, float ofy, float ocx, float ocy, float ifx, float ify,
                              float icx, float icy, float k1, float k2, float k3, float k4,
                              int fisheye, float border, int interp, const void* rays,
                              const void* levels, int levels_nx, const void* lv1,
                              long long lv1_plane, int lv1_pitch, int lv1_h, int lv1_w,
                              const void* lv2, long long lv2_plane, int lv2_pitch, int lv2_h,
                              int lv2_w, int band_rows, int band_off, void* stream) {
  WarpParams p{1.0f / ofx, 1.0f / ofy, ocx, ocy, ifx, ify, icx, icy, k1, k2, k3, k4,
               border, in_w, in_h, out_w, out_h, fisheye};
  const bool band = band_rows > 0;
  if (ny < 0 || t < 1 || (f32 && t > 1 && nplanes != 1) ||
      (band && (!f32 || t != 1 || nplanes != 1 || ny != 0 || levels != nullptr ||
                band_off < 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  Modes m{static_cast<const float*>(rays), static_cast<const uint8_t*>(levels), levels_nx,
          {{src, (long long)in_h * in_w, in_w, in_h, in_w},
           {lv1, lv1_plane, lv1_pitch, lv1_h, lv1_w},
           {lv2, lv2_plane, lv2_pitch, lv2_h, lv2_w}},
          (out_h + TILE_ROWS - 1) / TILE_ROWS, band_off};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rot);
  const bool launched =
      band  ? launch_band(interp, band_rows, s, dst, r, p, m)
      : f32 ? launch<float>(nplanes, interp, t, ny, s, dst, r, p, m)
            : launch<uint8_t>(nplanes, interp, t, ny, s, dst, r, p, m);
  if (!launched) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
