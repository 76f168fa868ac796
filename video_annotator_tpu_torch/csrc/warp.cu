// K1: fused warp map + bilinear remap, in three modes that share one map
// and one tap routine.
//
// Replaces the TPU fused warp video_annotator_tpu/ops/warp_pallas.py
// (_make_kernel :923-1499) as built by
//   _build_warp_yuv_batch_fn :2141  -- a frame batch to uint8, per-frame
//       3x3: luma kernel call_y and two-plane chroma kernel call_c
//       (batched="uv", border=128)                      -> vat_warp_u8, T > 1
//   _build_warp_yuv_fn :2041/:2066  -- one frame to uint8, one 3x3: the
//       same two kernels                                -> vat_warp_u8, T = 1
//   _build_warp_fn :1803            -- one float plane, one 3x3, float32
//       output, not rounded                             -> vat_warp_f32, P = 1
//   _build_warp_planes_fn :1957     -- P planes of one frame sharing one
//       map (batched="planes", border=128 for chroma)   -> vat_warp_f32, P > 1
//   _build_warp_batch_fn :1860      -- T float planes, one 3x3 per frame,
//       float32 output (batched=True)                   -> vat_warp_f32, T > 1
//   _build_warp_band_fn :2303       -- output tile rows [off, off + ny_band)
//       of one float frame, the row index clamped to the last tile row
//       (batched="band", :983-993, :1104-1107)          -> vat_warp_f32_band
// and the rolling-shutter mode of each of them (_make_kernel(rs=True),
// :925-927, :1142-1149): one 3x3 per 8-row output tile row instead of one
// per frame -> the same entries with ny > 0. Output row y of frame t then
// takes rot[t][min(y / 8, ny - 1)], the oracle's rule
// (video_annotator_tpu/ops/warp_xla.py:55-56); all after the rotation is
// unchanged. The 32x8 block covers exactly one tile row, so the row index
// is the block's own (blockIdx.y) and no thread does rotation arithmetic
// of its own. The mode is a template argument: the whole-frame kernels are
// instruction for instruction what they were without it.
//
// Per output pixel of a rectilinear output camera: ray = ((x-ocx)/ofx,
// (y-ocy)/ofy, 1) (as a product with 1/ofx, taken once on the host, which
// is how the plain version's division of a tensor by a scalar runs on the
// card), v = R ray, a = vx/vz, b = vy/vz; for a fisheye input
// theta = atan(r)(1+k1 t^2+..+k4 t^8), s = theta/r; then exact 2x2 bilinear
// sampling with out-of-image taps reading `border`. The sampling is centred
// on the border value like the XLA oracle
// (video_annotator_tpu/pipeline/render.py:1806-1812): taps contribute
// (p - border), the sum gets + border. The uint8 mode rounds half to even
// (rintf) and clamps; the float mode stores the sum as it is. R is any 3x3:
// a rotation between real cameras, or a homogeneous pixel matrix between
// identity pinhole cameras (f = 1, c = 0), where the "ray" is the pixel
// coordinate and vz is exactly 1.
//
// The frame batch (row 6) and the band (row 9) are kernels of their own
// (warp_f32_batch_kernel, warp_f32_band_kernel), so the one-frame float
// kernel is instruction for instruction what it was without them: the
// batch takes its frame from blockIdx.z and its 3x3 at rot + 9 t, as the
// uint8 kernel does; the band maps its block row b to the global tile
// row min(b + off, ny - 1), so the overflow tiles of a last band that
// ceil(ny / nshards) overshoots recompute the final tile row, and it
// computes every row of a tile, those past out_h included (the caller
// crops them). The TPU build capped a dispatch at max_t frames to fit its
// scalar memory (warp_pallas.py:1911-1923); this kernel prefetches no
// metadata and takes any T.
//
// The diagnostic builds of the uint8 luma batch (DIAG, a template argument
// of warp_kernel; the TPU kernel's VAT_WARP_DIAG builds no_dma and no_walk,
// warp_pallas.py:146-153, :406-422, :1083, :1434) split K1's time on the
// card into its parts: the map (RowMap::coords), the taps (the four __ldg
// of ByteTaps) and the scaffolding (the index math, the validity
// branch, the rounding and the store). NO_TAPS runs the map and the blend
// but reads no source byte: each in-image tap takes the value DIAG_TAP, so
// the output is the warp of a flat plane. NO_MAP takes no 3x3 product and
// no projection: the source coordinates are the output pixel's own scaled
// to the source extent, one product per axis, and the taps run as usual,
// with a locality close to the real map's. Their output pixels are
// garbage, for timing only; each has its own entry, which no render
// reaches. DIAG = 0 is the product kernel; the three builds follow its
// grouped design (8 columns a thread, one plane).
//
// K1's 4-tap, ray-grid and per-tile mip modes are csrc/warp_modes.cu; the
// helpers the two sources share (the camera parameters, the per-tile-row
// rotation, the unfused arithmetic, the input projection) are
// csrc/warp_common.cuh.
//
// Bound on Hopper: the uint8 mode by the instructions it issues, not by
// its bytes or its arithmetic. At one thread per output pixel it took
// 204-210 issue slots a pixel against the 68 operations its floor counts
// (about 28 for the map between rectilinear cameras, 20 more for a
// fisheye input, 20 per plane for the taps), 92-95 of them scaffolding:
// index math, validity tests, blend, rounding and the one-byte store
// (tools/roofline.py). The map's IEEE divisions, sqrtf and atanf stay, for
// the bits. The float mode moves 4 bytes per source and output element
// and sits nearer its byte bound.
//
// Design, the float kernels: one thread per output pixel, a 32x8 block
// so a warp covers 32 consecutive output columns (coalesced stores, taps
// of neighbouring pixels hit the same source cache lines), the source
// read straight from global memory through the read-only cache.
// The uint8 kernel: a thread renders GROUP<NPLANES> consecutive columns
// of one row (8 luma, 4 chroma), the block still 32x8 threads, so a block
// row stays one `rs` tile row. The thread pays once per group for its
// index math, bounds test, frame and plane bases (64-bit, then 32-bit
// offsets inside a plane), the 3x3 and the row's three products (RowMap);
// every pixel keeps the plain version's own expressions, so the bits do
// not move. A pixel at a time: the map, then an interior test on its
// float coordinates (all four taps in the image), whose taps are read
// without predicates (ByteTaps::interior), the others as before
// (ByteTaps::edge); each plane's group leaves as 32-bit words where the
// row and alignment allow. On an H100 (700 W) at the 4K shapes this
// takes the 32-frame luma launch to 0.78 of the one-pixel-a-thread
// kernel and the chroma launch to 0.90 (tools/time_warp_builds.py, both
// sources timed in turns); the map, kept bit for bit, is now half of
// the time (tools/roofline.py). Exact float32 tricks in place of the
// conversion instructions (floor, a byte's float, the rounding) gained
// nothing: that pipe does not bind. One thread computes the map once and
// samples every plane of its frame. No VMEM windows, origin passes or
// packed layouts: those served the TPU's lane gather.

#include "warp_common.cuh"

namespace {

constexpr int DIAG_NO_TAPS = 1;
constexpr int DIAG_NO_MAP = 2;
constexpr float DIAG_TAP = 200.0f;  // NO_TAPS: the flat plane's value

// Source coordinates of output pixel (x, y) under the 3x3 `r`. False when
// every tap falls outside the image or the ray points behind the camera.
__device__ __forceinline__ bool source_coords(const WarpParams& p,
                                              const float* __restrict__ r, int x,
                                              int y, float* sx, float* sy) {
  const float rx = mul((float)x - p.ocx, p.inv_ofx);
  const float ry = mul((float)y - p.ocy, p.inv_ofy);
  const float vx = add(add(mul(r[0], rx), mul(r[1], ry)), r[2]);
  const float vy = add(add(mul(r[3], rx), mul(r[4], ry)), r[5]);
  const float vz = add(add(mul(r[6], rx), mul(r[7], ry)), r[8]);
  input_coords(p, vx, vy, vz, sx, sy);
  return *sx > -1.0f && *sx < (float)p.in_w && *sy > -1.0f &&
         *sy < (float)p.in_h && vz > 1e-6f;
}

// The 2x2 bilinear taps around (sx, sy) of one plane, centred on the
// border: out-of-image taps contribute 0, the sum gets + border.
struct Taps {
  float fx, fy;
  size_t row0, row1;
  int xi;
  bool in_x0, in_x1, in_y0, in_y1;

  __device__ __forceinline__ Taps(const WarpParams& p, float sx, float sy) {
    const float x0 = floorf(sx);
    const float y0 = floorf(sy);
    fx = sx - x0;
    fy = sy - y0;
    xi = (int)x0;
    const int yi = (int)y0;
    in_x0 = xi >= 0;
    in_x1 = xi + 1 < p.in_w;
    in_y0 = yi >= 0;
    in_y1 = yi + 1 < p.in_h;
    row0 = (size_t)yi * p.in_w;
    row1 = row0 + p.in_w;
  }

  template <typename T>
  __device__ __forceinline__ float sample(const T* __restrict__ s, float border) const {
    const float v00 = (in_y0 && in_x0) ? (float)__ldg(s + row0 + xi) - border : 0.0f;
    const float v01 = (in_y0 && in_x1) ? (float)__ldg(s + row0 + xi + 1) - border : 0.0f;
    const float v10 = (in_y1 && in_x0) ? (float)__ldg(s + row1 + xi) - border : 0.0f;
    const float v11 = (in_y1 && in_x1) ? (float)__ldg(s + row1 + xi + 1) - border : 0.0f;
    return blend(v00, v01, v10, v11, border);
  }

  __device__ __forceinline__ float blend(float v00, float v01, float v10, float v11,
                                         float border) const {
    const float top = add(mul(v00, 1.0f - fx), mul(v01, fx));
    const float bot = add(mul(v10, 1.0f - fx), mul(v11, fx));
    return add(add(mul(top, 1.0f - fy), mul(bot, fy)), border);
  }
};

// The uint8 kernel's output columns per thread: GROUP<NPLANES>
// consecutive pixels of one row share the thread's index math, bounds
// test, frame and plane bases, 3x3 fetch and row products, and leave in
// one store per plane. On an H100 at the 4K shapes 8 took the 32-frame
// luma launch to 0.97 of 4 and the chroma launch to 1.04 of 4; 2 was
// slower for both (tools/time_warp_builds.py).
template <int NPLANES>
constexpr int GROUP = NPLANES == 1 ? 8 : 4;

// source_coords for the pixels of one output row: the row's products
// r[1] ry, r[4] ry, r[7] ry taken once. Every value is the one
// source_coords rounds (the same unfused products and sums in the same
// order), so the coordinates agree bit for bit. The bounds tests are the
// caller's.
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

// The 2x2 taps of one uint8 plane at (sx, sy), Taps's values with 32-bit
// offsets inside the plane (the host refuses a plane of 2^31 bytes). The
// caller tells an interior
// pixel, whose four taps all lie in the image, from its coordinates:
// floor(sx) >= 0 and floor(sx) + 1 < in_w are sx >= 0 and sx < in_w - 1.
// Its taps are read without predicates (interior), the others' as Taps
// reads them (edge). Both give Taps::sample's bits.
struct ByteTaps {
  float fx, fy;
  int xi, yi;
  int off;  // yi * in_w + xi

  __device__ __forceinline__ ByteTaps(const WarpParams& p, float sx, float sy) {
    const float x0 = floorf(sx);
    const float y0 = floorf(sy);
    fx = sx - x0;
    fy = sy - y0;
    xi = (int)x0;
    yi = (int)y0;
    off = yi * p.in_w + xi;
  }

  __device__ __forceinline__ float interior(const uint8_t* __restrict__ s, int in_w,
                                            float border) const {
    const uint8_t* q = s + off;
    return blend((float)__ldg(q) - border, (float)__ldg(q + 1) - border,
                 (float)__ldg(q + in_w) - border, (float)__ldg(q + in_w + 1) - border, border);
  }

  __device__ __forceinline__ float edge(const WarpParams& p, const uint8_t* __restrict__ s,
                                        float border) const {
    const bool in_x0 = xi >= 0, in_x1 = xi + 1 < p.in_w;
    const bool in_y0 = yi >= 0, in_y1 = yi + 1 < p.in_h;
    const uint8_t* q = s + off;
    const float v00 = (in_y0 && in_x0) ? (float)__ldg(q) - border : 0.0f;
    const float v01 = (in_y0 && in_x1) ? (float)__ldg(q + 1) - border : 0.0f;
    const float v10 = (in_y1 && in_x0) ? (float)__ldg(q + p.in_w) - border : 0.0f;
    const float v11 = (in_y1 && in_x1) ? (float)__ldg(q + p.in_w + 1) - border : 0.0f;
    return blend(v00, v01, v10, v11, border);
  }

  // Taps::flat: a flat plane of `value` that is never read (NO_TAPS).
  __device__ __forceinline__ float flat(const WarpParams& p, float value, float border) const {
    const bool in_x0 = xi >= 0, in_x1 = xi + 1 < p.in_w;
    const bool in_y0 = yi >= 0, in_y1 = yi + 1 < p.in_h;
    const float v = value - border;
    return blend((in_y0 && in_x0) ? v : 0.0f, (in_y0 && in_x1) ? v : 0.0f,
                 (in_y1 && in_x0) ? v : 0.0f, (in_y1 && in_x1) ? v : 0.0f, border);
  }

  __device__ __forceinline__ float blend(float v00, float v01, float v10, float v11,
                                         float border) const {
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

// (T, NPLANES, in_h, in_w) uint8 -> (T, NPLANES, out_h, out_w) uint8, one
// 3x3 per frame or per tile row of a frame; DIAG 0, or the diagnostic
// build's bits. A thread renders G = GROUP<NPLANES> consecutive columns
// of one row, a pixel at a time (map, taps, byte); a 32x8 block covers
// 32 * G columns of one 8-row tile row.
template <int NPLANES, bool RS, int DIAG>
__global__ void warp_kernel(const uint8_t* __restrict__ src,
                            uint8_t* __restrict__ dst,
                            const float* __restrict__ rot, WarpParams p, int ny) {
  constexpr int G = GROUP<NPLANES>;
  const int x0 = (blockIdx.x * blockDim.x + threadIdx.x) * G;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int t = blockIdx.z;
  // With RS nine of the block's threads fetch its 3x3 once, before any
  // thread leaves. On an H100 at the 4K shapes this took 3 to 4% off the
  // one-pixel-a-thread launch against every thread reading the nine
  // floats through the read-only cache; the float kernel, bound by bytes,
  // lost 2% to the barrier and reads them direct (tools/time_warp_builds.py).
  __shared__ float staged[9];
  const float* r = row_rotation<RS>(ny, rot, t);
  if (RS) {
    const int i = threadIdx.y * blockDim.x + threadIdx.x;
    if (i < 9) staged[i] = __ldg(r + i);
    __syncthreads();
    r = staged;
  }
  if (x0 >= p.out_w || y >= p.out_h) return;
  const int n = min(G, p.out_w - x0);

  const size_t in_plane = (size_t)p.in_h * p.in_w;
  const size_t out_plane = (size_t)p.out_h * p.out_w;
  const uint8_t* in = src + (size_t)t * NPLANES * in_plane;
  const uint8_t bu8 = to_u8(p.border);
  const float xf0 = (float)x0;  // (float)(x0 + j) is xf0 + j, exactly
  const float w1 = (float)(p.in_w - 1), h1 = (float)(p.in_h - 1);
  uint8_t b[NPLANES][G];
  const RowMap row(p, r, y);  // unread, so not loaded, in the NO_MAP builds
  // Columns past out_w (a ragged last group) are computed, not stored.
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const float xf = add(xf0, (float)j);
    float sx, sy;
    bool ahead = true;
    if constexpr (DIAG & DIAG_NO_MAP) {
      sx = mul(xf, p.inv_ofx);
      sy = mul((float)y, p.inv_ofy);
    } else {
      ahead = row.coords(p, xf, &sx, &sy);
    }
    if (ahead && sx >= 0.0f && sx < w1 && sy >= 0.0f && sy < h1) {
      const ByteTaps taps(p, sx, sy);
#pragma unroll
      for (int pl = 0; pl < NPLANES; ++pl) {
        if constexpr (DIAG & DIAG_NO_TAPS) {
          b[pl][j] = to_u8(taps.flat(p, DIAG_TAP, p.border));
        } else {
          b[pl][j] = to_u8(taps.interior(in + pl * in_plane, p.in_w, p.border));
        }
      }
    } else if (ahead && sx > -1.0f && sx < (float)p.in_w && sy > -1.0f &&
               sy < (float)p.in_h) {
      const ByteTaps taps(p, sx, sy);
#pragma unroll
      for (int pl = 0; pl < NPLANES; ++pl) {
        if constexpr (DIAG & DIAG_NO_TAPS) {
          b[pl][j] = to_u8(taps.flat(p, DIAG_TAP, p.border));
        } else {
          b[pl][j] = to_u8(taps.edge(p, in + pl * in_plane, p.border));
        }
      }
    } else {
#pragma unroll
      for (int pl = 0; pl < NPLANES; ++pl) b[pl][j] = bu8;
    }
  }
  uint8_t* out = dst + (size_t)t * NPLANES * out_plane + (size_t)y * p.out_w + x0;
  const bool aligned = ((reinterpret_cast<uintptr_t>(out) | out_plane) & 3) == 0;
#pragma unroll
  for (int pl = 0; pl < NPLANES; ++pl) store_group(out + pl * out_plane, b[pl], n, aligned);
}

// (NPLANES, in_h, in_w) float32 planes of one frame -> (NPLANES, out_h,
// out_w) float32 under ONE 3x3 or one per tile row; neither rounded nor
// clamped.
template <int NPLANES, bool RS>
__global__ void warp_f32_kernel(const float* __restrict__ src,
                                float* __restrict__ dst,
                                const float* __restrict__ rot, WarpParams p, int ny) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x >= p.out_w || y >= p.out_h) return;

  float sx, sy;
  const bool valid = source_coords(p, row_rotation<RS>(ny, rot, 0), x, y, &sx, &sy);
  const size_t in_plane = (size_t)p.in_h * p.in_w;
  const size_t out_plane = (size_t)p.out_h * p.out_w;
  float* out = dst + (size_t)y * p.out_w + x;
  if (!valid) {
#pragma unroll
    for (int pl = 0; pl < NPLANES; ++pl) out[pl * out_plane] = p.border;
    return;
  }
  const Taps taps(p, sx, sy);
#pragma unroll
  for (int pl = 0; pl < NPLANES; ++pl) {
    out[pl * out_plane] = taps.sample(src + pl * in_plane, p.border);
  }
}

// (T, in_h, in_w) float32 -> (T, out_h, out_w) float32: frame t =
// blockIdx.z under its own 3x3 at rot + 9 t; neither rounded nor clamped.
__global__ void warp_f32_batch_kernel(const float* __restrict__ src, float* __restrict__ dst,
                                      const float* __restrict__ rot, WarpParams p) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int t = blockIdx.z;
  if (x >= p.out_w || y >= p.out_h) return;

  float sx, sy;
  const bool valid = source_coords(p, rot + t * 9, x, y, &sx, &sy);
  const size_t in_plane = (size_t)p.in_h * p.in_w;
  float* out = dst + (size_t)t * p.out_h * p.out_w + (size_t)y * p.out_w + x;
  *out = valid ? Taps(p, sx, sy).sample(src + t * in_plane, p.border) : p.border;
}

// One (in_h, in_w) float32 frame -> (gridDim.y * 8, out_w) float32: block
// row b renders global tile row min(b + off, ny - 1), all 8 of its rows.
__global__ void warp_f32_band_kernel(const float* __restrict__ src, float* __restrict__ dst,
                                     const float* __restrict__ rot, WarpParams p, int ny,
                                     int off) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int gy = min((int)blockIdx.y + off, ny - 1) * TILE_ROWS + (int)threadIdx.y;
  if (x >= p.out_w) return;

  float sx, sy;
  const bool valid = source_coords(p, rot, x, gy, &sx, &sy);
  dst[(size_t)y * p.out_w + x] = valid ? Taps(p, sx, sy).sample(src, p.border) : p.border;
}

// The uint8 kernel's grid: a block per 32 * group columns of a tile row
// of a frame.
dim3 u8_grid(int t, int nplanes, int out_h, int out_w) {
  const int cols = 32 * (nplanes == 1 ? GROUP<1> : GROUP<2>);
  return dim3((out_w + cols - 1) / cols, (out_h + TILE_ROWS - 1) / TILE_ROWS, t);
}

// Whether a source plane's taps fit the uint8 kernel's 32-bit offsets.
bool plane_fits(int in_h, int in_w) {
  return (long long)(in_h + 1) * in_w < (1LL << 31);
}

// The launches by plane count, for one rotation mode.
template <bool RS>
bool launch_u8(int nplanes, dim3 grid, dim3 block, cudaStream_t s, const uint8_t* in,
               uint8_t* out, const float* r, const WarpParams& p, int ny) {
  switch (nplanes) {
    case 1: warp_kernel<1, RS, 0><<<grid, block, 0, s>>>(in, out, r, p, ny); return true;
    case 2: warp_kernel<2, RS, 0><<<grid, block, 0, s>>>(in, out, r, p, ny); return true;
    default: return false;
  }
}

template <bool RS>
bool launch_f32(int nplanes, dim3 grid, dim3 block, cudaStream_t s, const float* in,
                float* out, const float* r, const WarpParams& p, int ny) {
  switch (nplanes) {
    case 1: warp_f32_kernel<1, RS><<<grid, block, 0, s>>>(in, out, r, p, ny); return true;
    case 2: warp_f32_kernel<2, RS><<<grid, block, 0, s>>>(in, out, r, p, ny); return true;
    case 3: warp_f32_kernel<3, RS><<<grid, block, 0, s>>>(in, out, r, p, ny); return true;
    case 4: warp_f32_kernel<4, RS><<<grid, block, 0, s>>>(in, out, r, p, ny); return true;
    default: return false;
  }
}

// The diagnostic builds of the luma batch (DIAG above), each its own entry
// with vat_warp_u8's arguments: one plane (nplanes 1), one 3x3 per frame
// (ny 0). NO_MAP takes in_w / out_w and in_h / out_h in place of 1 / ofx
// and 1 / ofy, computed here in float32 as its plain version does.
template <int DIAG>
int warp_luma_diag(const void* src, void* dst, const void* rot, int t, int nplanes,
                   int in_h, int in_w, int out_h, int out_w, int ny, float ofx, float ofy,
                   float ocx, float ocy, float ifx, float ify, float icx, float icy,
                   float k1, float k2, float k3, float k4, int fisheye, float border,
                   void* stream) {
  WarpParams p{1.0f / ofx, 1.0f / ofy, ocx, ocy, ifx, ify, icx, icy, k1, k2, k3, k4,
               border, in_w, in_h, out_w, out_h, fisheye};
  if (DIAG & DIAG_NO_MAP) {
    p.inv_ofx = (float)in_w / (float)out_w;
    p.inv_ofy = (float)in_h / (float)out_h;
  }
  if (nplanes != 1 || ny != 0 || t < 1 || !plane_fits(in_h, in_w))
    return static_cast<int>(cudaErrorInvalidValue);
  warp_kernel<1, false, DIAG><<<u8_grid(t, 1, out_h, out_w), dim3(32, TILE_ROWS), 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst),
      static_cast<const float*>(rot), p, 0);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int vat_warp_u8(const void* src, void* dst, const void* rot, int t,
                           int nplanes, int in_h, int in_w, int out_h, int out_w,
                           int ny, float ofx, float ofy, float ocx, float ocy, float ifx,
                           float ify, float icx, float icy, float k1, float k2,
                           float k3, float k4, int fisheye, float border,
                           void* stream) {
  WarpParams p{1.0f / ofx, 1.0f / ofy, ocx, ocy, ifx, ify, icx, icy, k1, k2, k3, k4,
               border, in_w, in_h, out_w, out_h, fisheye};
  if (ny < 0 || !plane_fits(in_h, in_w)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(32, TILE_ROWS);
  const dim3 grid = u8_grid(t, nplanes, out_h, out_w);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uint8_t* in = static_cast<const uint8_t*>(src);
  uint8_t* out = static_cast<uint8_t*>(dst);
  const float* r = static_cast<const float*>(rot);
  const bool launched = ny > 0 ? launch_u8<true>(nplanes, grid, block, s, in, out, r, p, ny)
                               : launch_u8<false>(nplanes, grid, block, s, in, out, r, p, ny);
  if (!launched) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// t frames: 1 for the planes of one frame (rows 5, 7), else a stack of t
// single planes under one 3x3 each (row 6: nplanes 1, ny 0).
extern "C" int vat_warp_f32(const void* src, void* dst, const void* rot, int t,
                            int nplanes, int in_h, int in_w, int out_h, int out_w,
                            int ny, float ofx, float ofy, float ocx, float ocy, float ifx,
                            float ify, float icx, float icy, float k1, float k2,
                            float k3, float k4, int fisheye, float border,
                            void* stream) {
  WarpParams p{1.0f / ofx, 1.0f / ofy, ocx, ocy, ifx, ify, icx, icy, k1, k2, k3, k4,
               border, in_w, in_h, out_w, out_h, fisheye};
  if (ny < 0 || t < 1 || (t > 1 && (nplanes != 1 || ny != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(32, TILE_ROWS);
  const dim3 grid((out_w + 31) / 32, (out_h + TILE_ROWS - 1) / TILE_ROWS, t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* in = static_cast<const float*>(src);
  float* out = static_cast<float*>(dst);
  const float* r = static_cast<const float*>(rot);
  if (t > 1) {
    warp_f32_batch_kernel<<<grid, block, 0, s>>>(in, out, r, p);
    return static_cast<int>(cudaGetLastError());
  }
  const bool launched = ny > 0 ? launch_f32<true>(nplanes, grid, block, s, in, out, r, p, ny)
                               : launch_f32<false>(nplanes, grid, block, s, in, out, r, p, ny);
  if (!launched) return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// Tile rows [off, off + ny_band) of one frame's ny = ceil(out_h / 8), each
// clamped to ny - 1, into (ny_band * 8, out_w) float32.
extern "C" int vat_warp_f32_band(const void* src, void* dst, const void* rot, int in_h,
                                 int in_w, int out_h, int out_w, int ny_band, int off,
                                 float ofx, float ofy, float ocx, float ocy, float ifx,
                                 float ify, float icx, float icy, float k1, float k2,
                                 float k3, float k4, int fisheye, float border,
                                 void* stream) {
  WarpParams p{1.0f / ofx, 1.0f / ofy, ocx, ocy, ifx, ify, icx, icy, k1, k2, k3, k4,
               border, in_w, in_h, out_w, out_h, fisheye};
  const int ny = (out_h + TILE_ROWS - 1) / TILE_ROWS;
  if (ny_band < 1 || off < 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(32, TILE_ROWS);
  const dim3 grid((out_w + 31) / 32, ny_band, 1);
  warp_f32_band_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(src), static_cast<float*>(dst),
      static_cast<const float*>(rot), p, ny, off);
  return static_cast<int>(cudaGetLastError());
}

#define VAT_WARP_LUMA_DIAG(entry, diag)                                                   \
  extern "C" int entry(const void* src, void* dst, const void* rot, int t, int nplanes,   \
                       int in_h, int in_w, int out_h, int out_w, int ny, float ofx,       \
                       float ofy, float ocx, float ocy, float ifx, float ify, float icx,  \
                       float icy, float k1, float k2, float k3, float k4, int fisheye,    \
                       float border, void* stream) {                                      \
    return warp_luma_diag<diag>(src, dst, rot, t, nplanes, in_h, in_w, out_h, out_w, ny,  \
                                ofx, ofy, ocx, ocy, ifx, ify, icx, icy, k1, k2, k3, k4,   \
                                fisheye, border, stream);                                 \
  }

VAT_WARP_LUMA_DIAG(vat_warp_luma_diag_no_taps, DIAG_NO_TAPS)
VAT_WARP_LUMA_DIAG(vat_warp_luma_diag_no_map, DIAG_NO_MAP)
VAT_WARP_LUMA_DIAG(vat_warp_luma_diag_no_map_no_taps, DIAG_NO_MAP | DIAG_NO_TAPS)
