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
// as the uint8 batch takes its frames) and the band of
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
//
// Design, grouped for Hopper as csrc/warp.cu's float kernels: lane l of a
// 32x8 block (one tile row of the level map) renders GROUP<NPLANES>
// columns of one row, 32 apart (the block's first column + l + 32 j), so
// each warp load of rays or taps and each store covers 32 consecutive
// pixels, and pays once for its index math, bounds test, the 3x3 and the
// rectilinear row's three products (RowMap). Its pixels go one at a time,
// not unrolled: unrolled, a 4-tap kernel holds the taps of several pixels
// and its registers cut the blocks an SM holds. Per pixel: the map, the
// validity test, the level's coordinates (the level map read at x / 128),
// then an interior test on them (all 2x2 or 4x4 taps inside the level:
// sx >= 0 and sx < w - 1, or sx >= 1 and sx < w - 2), whose taps are read
// without predicates at 32-bit offsets inside the plane; the other
// pixels' taps as before, each behind its bounds tests. A ray-grid launch
// of more than one frame loops over its frames inside each pixel (the
// frame-inner loop), the ray read once a launch, not once a frame. Bicubic
// evaluates only the branch of Keys's kernel that each of its four
// offsets can take (fx + 1 and 2 - fx lie in [1, 2], fx and 1 - fx in
// [0, 1]), which keeps keys's rule bit for bit, the rounded fx + 1 that
// reaches 2.0 included. Lanczos keeps its sinf and IEEE divisions (the
// bits of torch.sin and of the plain version) and gains only from the
// scaffolding. Each kernel is held to the blocks an SM must keep
// (MIN_BLOCKS). On an H100 (700 W) at the 4K shapes, against the
// one-pixel-a-thread kernel in turns (tools/time_warp_builds.py): the
// 32-frame bicubic uint8 batch 0.77 (luma) and 0.89 (chroma), lanczos
// 0.85 and 0.94, bicubic on a stereographic grid 0.81 (float luma), the
// equirect ray-grid batch 0.79 (32 luma frames) and 0.78 (8 float
// frames); a float mip launch of two small planes 1.17, slower.

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
  int frames;             // frames a thread renders: 1 (blockIdx.z is its frame) or all
};

__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

template <typename T>
__device__ __forceinline__ T convert(float v);
template <>
__device__ __forceinline__ uint8_t convert<uint8_t>(float v) { return to_u8(v); }
template <>
__device__ __forceinline__ float convert<float>(float v) { return v; }

// warp_plain.keys_weight, a = -0.75, on each side of |t| = 1
__device__ __forceinline__ float keys_near(float t) {  // |t| <= 1
  return add(mul(mul(sub(mul(1.25f, t), 2.25f), t), t), 1.0f);
}
__device__ __forceinline__ float keys_far(float t) {  // 1 < |t| < 2
  return mul(-0.75f, sub(mul(add(mul(sub(t, 5.0f), t), 8.0f), t), 4.0f));
}

// warp_plain.lanczos_weight, a = 2: sin(pi t) sin(pi t / 2) 2 / (pi t)^2
__device__ __forceinline__ float lanczos(float t) {
  t = fabsf(t);
  const float pt = mul(3.14159265358979323846f, fmaxf(t, 1e-6f));
  const float win =
      mul(mul(sinf(pt), sinf(mul(pt, 0.5f))), mul(__fdiv_rn(1.0f, mul(pt, pt)), 2.0f));
  return t < 1e-6f ? 1.0f : (t < 2.0f ? win : 0.0f);
}

// The four weights at offsets -1..2 of fraction f in [0, 1] (floor's
// fraction; 1.0 only where a tiny negative coordinate rounds up to it):
// w[k] = weight(f - (k - 1)). Bicubic: |f - k + 1| is f + 1 or 2 - f in
// [1, 2], where keys gives its far branch inside (1, 2) and 0 at either
// end (near(1) is +0, the far branch's value there -0), and f or 1 - f in
// [0, 1], where it gives its near branch.
template <int INTERP>
__device__ __forceinline__ void weights(float f, float (&w)[4]) {
  if constexpr (INTERP == BICUBIC) {
    const float t0 = fabsf(sub(f, -1.0f)), t3 = fabsf(sub(f, 2.0f));
    w[0] = t0 > 1.0f && t0 < 2.0f ? keys_far(t0) : 0.0f;
    w[1] = keys_near(fabsf(sub(f, 0.0f)));
    w[2] = keys_near(fabsf(sub(f, 1.0f)));
    w[3] = t3 > 1.0f && t3 < 2.0f ? keys_far(t3) : 0.0f;
  } else {
#pragma unroll
    for (int k = 0; k < 4; ++k) w[k] = lanczos(sub(f, (float)(k - 1)));
  }
}

__device__ __forceinline__ Level pick(const Modes& m, int l) {
  return l == 0 ? m.level[0] : (l == 1 ? m.level[1] : m.level[2]);
}

// Exact 2x2 bilinear taps of one plane of `lv` at (sx, sy), centred on the
// border, each tap behind its bounds tests (the edge path).
template <typename T>
__device__ __forceinline__ float sample2(const Level& lv, const T* __restrict__ plane, float sx,
                                         float sy, float border) {
  const float x0 = floorf(sx);
  const float y0 = floorf(sy);
  const float fx = sx - x0;
  const float fy = sy - y0;
  const int xi = (int)x0;
  const int yi = (int)y0;
  const bool in_x0 = xi >= 0 && xi < lv.w, in_x1 = xi + 1 >= 0 && xi + 1 < lv.w;
  const bool in_y0 = yi >= 0 && yi < lv.h, in_y1 = yi + 1 >= 0 && yi + 1 < lv.h;
  const T* row0 = plane + (long long)yi * lv.pitch;
  const T* row1 = row0 + lv.pitch;
  const float v00 = (in_y0 && in_x0) ? (float)__ldg(row0 + xi) - border : 0.0f;
  const float v01 = (in_y0 && in_x1) ? (float)__ldg(row0 + xi + 1) - border : 0.0f;
  const float v10 = (in_y1 && in_x0) ? (float)__ldg(row1 + xi) - border : 0.0f;
  const float v11 = (in_y1 && in_x1) ? (float)__ldg(row1 + xi + 1) - border : 0.0f;
  return PixelTaps::blend2(fx, fy, v00, v01, v10, v11, border);
}

// The 4x4 taps from q (the tap at -1, -1), rows `pitch` elements apart,
// all inside the plane: read without predicates.
template <typename T, int INTERP>
__device__ __forceinline__ float sample4_interior(const T* __restrict__ q, int pitch,
                                                  const float (&wx)[4], const float (&wy)[4],
                                                  float norm, float border) {
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const T* row = q + j * pitch;
    float line = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const float term = mul(wx[k], (float)__ldg(row + k) - border);
      line = k == 0 ? term : add(line, term);
    }
    const float term = mul(wy[j], line);
    acc = j == 0 ? term : add(acc, term);
  }
  if constexpr (INTERP == LANCZOS) acc = __fdiv_rn(acc, norm);
  return add(acc, border);
}

// The 4x4 taps at -1..2 around (xi, yi) of one plane of `lv`, weighted by
// wx (columns) and wy (rows): each row summed left to right, the rows top
// to bottom; lanczos divides by `norm`. Each tap behind its bounds tests
// (the edge path).
template <typename T, int INTERP>
__device__ __forceinline__ float sample4(const Level& lv, const T* __restrict__ plane, int xi,
                                         int yi, const float (&wx)[4], const float (&wy)[4],
                                         float norm, float border) {
  float acc = 0.0f;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int yy = yi - 1 + j;
    const bool in_y = yy >= 0 && yy < lv.h;
    const T* row = plane + (long long)yy * lv.pitch;
    float line = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int xx = xi - 1 + k;
      const float v = (in_y && xx >= 0 && xx < lv.w) ? (float)__ldg(row + xx) - border : 0.0f;
      const float term = mul(wx[k], v);
      line = k == 0 ? term : add(line, term);
    }
    const float term = mul(wy[j], line);
    acc = j == 0 ? term : add(acc, term);
  }
  if constexpr (INTERP == LANCZOS) acc = __fdiv_rn(acc, norm);
  return add(acc, border);
}

// One pixel of one frame at source coordinates (sx, sy) (ahead: its ray
// points in front of the camera) to out, plane 0's pixel: the validity
// test, the level's coordinates (level l of `lv`, `in` plane 0 of the
// frame there), then the interior test and unpredicated taps at 32-bit
// offsets, or the taps behind their bounds tests, or the border.
template <typename T, int NPLANES, int INTERP>
__device__ __forceinline__ void render_pixel(const WarpParams& p, float sx, float sy, bool ahead,
                                             int l, const Level& lv, const T* in, T* out,
                                             size_t out_plane) {
  constexpr float PAD = INTERP == BILINEAR ? 0.0f : 1.0f;
  if (!(ahead && sx > -1.0f - PAD && sx < (float)p.in_w + PAD && sy > -1.0f - PAD &&
        sy < (float)p.in_h + PAD)) {
#pragma unroll
    for (int pl = 0; pl < NPLANES; ++pl) out[pl * out_plane] = convert<T>(p.border);
    return;
  }
  if (l > 0) {
    const float s = l == 1 ? 0.5f : 0.25f;
    sx = sub(mul(add(sx, 0.5f), s), 0.5f);
    sy = sub(mul(add(sy, 0.5f), s), 0.5f);
  }
  // The interior: every tap inside the level.
  constexpr int LO = INTERP == BILINEAR ? 0 : 1, HI = INTERP == BILINEAR ? 1 : 2;
  const bool interior = sx >= (float)LO && sx < (float)(lv.w - HI) && sy >= (float)LO &&
                        sy < (float)(lv.h - HI);
  if constexpr (INTERP == BILINEAR) {
    if (interior) {
      const float x0f = floorf(sx), y0f = floorf(sy);
      const float fx = sx - x0f, fy = sy - y0f;
      const int off = (int)y0f * lv.pitch + (int)x0f;
#pragma unroll
      for (int pl = 0; pl < NPLANES; ++pl) {
        const T* q = in + pl * lv.plane + off;
        out[pl * out_plane] = convert<T>(PixelTaps::blend2(
            fx, fy, (float)__ldg(q) - p.border, (float)__ldg(q + 1) - p.border,
            (float)__ldg(q + lv.pitch) - p.border, (float)__ldg(q + lv.pitch + 1) - p.border,
            p.border));
      }
    } else {
#pragma unroll
      for (int pl = 0; pl < NPLANES; ++pl)
        out[pl * out_plane] = convert<T>(sample2<T>(lv, in + pl * lv.plane, sx, sy, p.border));
    }
  } else {
    const float x0f = floorf(sx), y0f = floorf(sy);
    const int xi = (int)x0f, yi = (int)y0f;
    float wx[4], wy[4], norm = 1.0f;
    weights<INTERP>(sx - x0f, wx);
    weights<INTERP>(sy - y0f, wy);
    if constexpr (INTERP == LANCZOS) {
      norm = mul(add(add(add(wx[0], wx[1]), wx[2]), wx[3]),
                 add(add(add(wy[0], wy[1]), wy[2]), wy[3]));
    }
    if (interior) {
      const int off = (yi - 1) * lv.pitch + (xi - 1);
#pragma unroll
      for (int pl = 0; pl < NPLANES; ++pl)
        out[pl * out_plane] = convert<T>(sample4_interior<T, INTERP>(
            in + pl * lv.plane + off, lv.pitch, wx, wy, norm, p.border));
    } else {
#pragma unroll
      for (int pl = 0; pl < NPLANES; ++pl)
        out[pl * out_plane] = convert<T>(sample4<T, INTERP>(lv, in + pl * lv.plane, xi, yi, wx,
                                                           wy, norm, p.border));
    }
  }
}

// Blocks of 32x8 threads an SM must hold at once. Left to itself a 4-tap
// kernel takes 64-120 registers a thread, two or three blocks; capped at
// 64 for four it spills a few bytes in some instantiations and runs 5-20%
// faster (5 blocks or 3 were slower). A bilinear kernel held to 6 blocks
// (at most 40 registers) runs its ray-grid batches 2-12% faster than with
// no minimum (8 blocks: mixed). On an H100 at the 4K shapes
// (tools/time_warp_builds.py).
template <int INTERP>
constexpr int MIN_BLOCKS = INTERP == BILINEAR ? 6 : 4;

// (T, NPLANES, in_h, in_w) planes (level 0 of `m`) -> (T, NPLANES, out_h,
// out_w) of type T: uint8 rounded half to even and clamped, or float32 as
// it is. One 3x3 per frame, or per tile row with RS. With BAND, one frame
// to (gridDim.y * 8, out_w): output row yo holds global row y. Lane l of
// a 32x8 block renders G = GROUP<NPLANES> columns of one row, 32 apart
// (the block's first column + l + 32 j), so each load of a warp, of rays,
// taps or the store, covers consecutive pixels; its frame is blockIdx.z
// or, in the frame-inner loop (m.frames > 1, a ray grid), every frame,
// each ray read once.
template <typename T, int NPLANES, bool RS, int INTERP, bool BAND = false>
__global__ void __launch_bounds__(256, MIN_BLOCKS<INTERP>)
    warp_modes_kernel(T* __restrict__ dst, const float* __restrict__ rot, WarpParams p, int ny,
                      Modes m) {
  constexpr int G = GROUP<NPLANES>;
  const int x0 = blockIdx.x * blockDim.x * G + threadIdx.x;
  const int yo = blockIdx.y * blockDim.y + threadIdx.y;
  int y = yo;
  if constexpr (BAND) {
    y = min((int)blockIdx.y + m.band_off, m.band_ny - 1) * TILE_ROWS + (int)threadIdx.y;
    if (x0 >= p.out_w) return;
  } else {
    if (x0 >= p.out_w || y >= p.out_h) return;
  }
  const size_t out_plane = (size_t)p.out_h * p.out_w;
  const uint8_t* levels = m.levels == nullptr ? nullptr
                                              : m.levels + (size_t)blockIdx.y * m.levels_nx;
  const int t0 = m.frames > 1 ? 0 : (int)blockIdx.z;
  T* row_out = dst + (size_t)yo * p.out_w;
  if (m.rays == nullptr) {
    const RowMap row(p, row_rotation<RS>(ny, rot, t0), y);
    T* out0 = row_out + (size_t)t0 * NPLANES * out_plane;
#pragma unroll 1
    for (int x = x0; x < min(p.out_w, x0 + 32 * G); x += 32) {
      float sx, sy;
      const bool ahead = row.coords(p, (float)x, &sx, &sy);
      const int l = levels != nullptr ? levels[x / TILE_COLS] : 0;
      const Level lv = pick(m, l);
      render_pixel<T, NPLANES, INTERP>(
          p, sx, sy, ahead, l, lv,
          static_cast<const T*>(lv.base) + (long long)t0 * NPLANES * lv.plane, out0 + x,
          out_plane);
    }
    return;
  }
  const size_t n_pix = out_plane;  // the grid's (3, out_h, out_w) planes
#pragma unroll 1
  for (int x = x0; x < min(p.out_w, x0 + 32 * G); x += 32) {
    const float* g = m.rays + (size_t)y * p.out_w + x;
    const float gx = __ldg(g), gy = __ldg(g + n_pix), gz = __ldg(g + 2 * n_pix);
    const int l = levels != nullptr ? levels[x / TILE_COLS] : 0;
    const Level lv = pick(m, l);
    for (int t = t0; t < t0 + m.frames; ++t) {
      const float* r = row_rotation<RS>(ny, rot, t);
      const float vx = add(add(mul(r[0], gx), mul(r[1], gy)), mul(r[2], gz));
      const float vy = add(add(mul(r[3], gx), mul(r[4], gy)), mul(r[5], gz));
      const float vz = add(add(mul(r[6], gx), mul(r[7], gy)), mul(r[8], gz));
      float sx, sy;
      input_coords(p, vx, vy, vz, &sx, &sy);
      render_pixel<T, NPLANES, INTERP>(
          p, sx, sy, vz > 1e-6f, l, lv,
          static_cast<const T*>(lv.base) + (long long)t * NPLANES * lv.plane,
          row_out + (size_t)t * NPLANES * out_plane + x, out_plane);
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

// uint8 takes 1 or 2 planes (luma, chroma), float up to 4. `z`: the
// grid's depth, t frames or 1 for the frame-inner loop.
template <typename T, bool RS>
bool launch_planes(int nplanes, int interp, int z, cudaStream_t s, T* out, const float* r,
                   const WarpParams& p, int ny, const Modes& m) {
  const dim3 block(32, TILE_ROWS);
  const dim3 grid = group_grid(z, group_of(nplanes), p.out_h, p.out_w);
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
  const dim3 grid = group_grid(1, GROUP<1>, band_rows * TILE_ROWS, p.out_w);
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

// A ray-grid launch of more than one frame renders them in the frame-inner
// loop, the rays loaded once a thread; any other launch takes its frame
// from blockIdx.z.
template <typename T>
bool launch(int nplanes, int interp, int t, int ny, cudaStream_t s, void* dst,
            const float* r, const WarpParams& p, Modes m) {
  const bool inner = m.rays != nullptr && t > 1;
  m.frames = inner ? t : 1;
  T* out = static_cast<T*>(dst);
  const int z = inner ? 1 : t;
  return ny > 0 ? launch_planes<T, true>(nplanes, interp, z, s, out, r, p, ny, m)
                : launch_planes<T, false>(nplanes, interp, z, s, out, r, p, ny, m);
}

// Whether every level the launch reads fits 32-bit offsets inside a plane.
bool levels_fit(const Modes& m, int item) {
  for (const Level& lv : m.level)
    if (lv.base != nullptr && !plane_fits(lv.h, lv.pitch, item)) return false;
  return true;
}

}  // namespace

// `f32`: float32 planes in and out, else uint8; t > 1 float frames take
// one plane each. `interp`: 0 bilinear, 1 bicubic, 2 lanczos. `rays`: null
// for a rectilinear output. `levels`: null without mip; levels 1 and 2 as
// (base, elements between planes, row pitch, rows, columns), a null base
// for a level the map never names. `band_rows` > 0: the band of one float
// plane, tile rows [band_off, band_off + band_rows) of the frame's
// ceil(out_h / 8), out_h the ray grid's padded rows. Refused: a level
// whose taps do not fit 32-bit offsets inside its plane.
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
  Modes m{static_cast<const float*>(rays), static_cast<const uint8_t*>(levels), levels_nx,
          {{src, (long long)in_h * in_w, in_w, in_h, in_w},
           {lv1, lv1_plane, lv1_pitch, lv1_h, lv1_w},
           {lv2, lv2_plane, lv2_pitch, lv2_h, lv2_w}},
          (out_h + TILE_ROWS - 1) / TILE_ROWS, band_off, 1};
  if (ny < 0 || t < 1 || (f32 && t > 1 && nplanes != 1) ||
      (band && (!f32 || t != 1 || nplanes != 1 || ny != 0 || levels != nullptr ||
                band_off < 0)) ||
      !levels_fit(m, f32 ? sizeof(float) : 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* r = static_cast<const float*>(rot);
  const bool launched =
      band  ? launch_band(interp, band_rows, s, dst, r, p, m)
      : f32 ? launch<float>(nplanes, interp, t, ny, s, dst, r, p, m)
            : launch<uint8_t>(nplanes, interp, t, ny, s, dst, r, p, m);
  if (!launched) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}
