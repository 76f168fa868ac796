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
// (warp_f32_batch_kernel, warp_f32_band_kernel): the batch takes its
// frame from blockIdx.z and its 3x3 at rot + 9 t, as the uint8 kernel
// does; the band maps its block row b to the global tile
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
// of PixelTaps) and the scaffolding (the index math, the validity
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
// rotation, the unfused arithmetic, the input projection, the grouped
// design's parts) are csrc/warp_common.cuh.
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
// Design, grouped for Hopper: a thread renders GROUP<NPLANES> columns of
// one row (8 for one plane, 4 for more), the block still 32x8 threads, so
// a block row stays one `rs` tile row. The thread pays once for its index
// math, bounds test, frame and plane bases (64-bit, then 32-bit offsets
// inside a plane), the 3x3 and the row's three products (RowMap); every
// pixel keeps the plain version's own expressions, so the bits do not
// move. A pixel at a time: the map, then an interior test on its float
// coordinates (all four taps in the image), whose taps are read without
// predicates (PixelTaps::interior), the others as before (PixelTaps::edge).
// The uint8 kernel's columns are consecutive and each plane's group leaves
// as 32-bit words where the row and alignment allow; on an H100 (700 W) at
// the 4K shapes this took the 32-frame luma launch to 0.78 of the
// one-pixel-a-thread kernel and the chroma launch to 0.90, the map, kept
// bit for bit, now half of the time (tools/roofline.py). The float
// kernels' columns lie 32 apart (lane + 32 j), so each warp's taps, loads
// and stores cover 32 consecutive pixels, which for 4-byte pixels beat
// consecutive columns with float4 stores (0.95 of them); the frame batch
// and the band follow the same design in kernels of their own. They take
// the 4K float launches to 0.86 (one plane; `rs` 0.83), 0.96 (two; `rs`
// 0.95), 0.77 (the 8-frame batch) and 0.85 (the last of 2 bands) of the
// one-pixel-a-thread kernels (tools/time_warp_builds.py, in turns). Exact
// float32 tricks in place of the conversion instructions (floor, a byte's
// float, the rounding) gained nothing: that pipe does not bind. One thread
// computes the map once and samples every plane of its frame. No VMEM
// windows, origin passes or packed layouts: those served the TPU's lane
// gather.

#include "warp_common.cuh"

namespace {

constexpr int DIAG_NO_TAPS = 1;
constexpr int DIAG_NO_MAP = 2;
constexpr float DIAG_TAP = 200.0f;  // NO_TAPS: the flat plane's value

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
      const PixelTaps taps(p, sx, sy);
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
      const PixelTaps taps(p, sx, sy);
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

// The G = GROUP<NPLANES> pixels of one float32 output row that a lane
// renders, columns x0 + 32 j (the block's first column + the lane + 32 j)
// under `row`: a pixel at a time the map, then the interior test and
// unpredicated taps, or the edge taps, or the border, as the uint8
// kernel; neither rounded nor clamped. `in`: plane 0 of the source frame;
// `out`: plane 0 of the output row; `out_plane`: the distance between
// output planes. Each load and store of a warp covers 32 consecutive
// pixels.
template <int NPLANES>
__device__ __forceinline__ void f32_group(const WarpParams& p, const RowMap& row, int x0,
                                          const float* __restrict__ in, float* out,
                                          size_t out_plane) {
  constexpr int G = GROUP<NPLANES>;
  const size_t in_plane = (size_t)p.in_h * p.in_w;
  const float w1 = (float)(p.in_w - 1), h1 = (float)(p.in_h - 1);
#pragma unroll
  for (int j = 0; j < G; ++j) {
    const int x = x0 + 32 * j;
    if (x >= p.out_w) break;
    float sx, sy;
    float v[NPLANES];
    const bool ahead = row.coords(p, (float)x, &sx, &sy);
    if (ahead && sx >= 0.0f && sx < w1 && sy >= 0.0f && sy < h1) {
      const PixelTaps taps(p, sx, sy);
#pragma unroll
      for (int pl = 0; pl < NPLANES; ++pl)
        v[pl] = taps.interior(in + pl * in_plane, p.in_w, p.border);
    } else if (ahead && sx > -1.0f && sx < (float)p.in_w && sy > -1.0f &&
               sy < (float)p.in_h) {
      const PixelTaps taps(p, sx, sy);
#pragma unroll
      for (int pl = 0; pl < NPLANES; ++pl) v[pl] = taps.edge(p, in + pl * in_plane, p.border);
    } else {
#pragma unroll
      for (int pl = 0; pl < NPLANES; ++pl) v[pl] = p.border;
    }
#pragma unroll
    for (int pl = 0; pl < NPLANES; ++pl) out[pl * out_plane + x] = v[pl];
  }
}

// (NPLANES, in_h, in_w) float32 planes of one frame -> (NPLANES, out_h,
// out_w) float32 under ONE 3x3 or one per tile row; neither rounded nor
// clamped. Lane l of a 32x8 block renders GROUP<NPLANES> columns of one
// row, 32 apart; the 3x3 is read direct (a block-wide staging cost this
// kernel 2% at one pixel a thread, tools/time_warp_builds.py).
template <int NPLANES, bool RS>
__global__ void warp_f32_kernel(const float* __restrict__ src,
                                float* __restrict__ dst,
                                const float* __restrict__ rot, WarpParams p, int ny) {
  const int x0 = blockIdx.x * blockDim.x * GROUP<NPLANES> + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  if (x0 >= p.out_w || y >= p.out_h) return;
  const RowMap row(p, row_rotation<RS>(ny, rot, 0), y);
  f32_group<NPLANES>(p, row, x0, src, dst + (size_t)y * p.out_w, (size_t)p.out_h * p.out_w);
}

// (T, in_h, in_w) float32 -> (T, out_h, out_w) float32: frame t =
// blockIdx.z under its own 3x3 at rot + 9 t; neither rounded nor clamped.
__global__ void warp_f32_batch_kernel(const float* __restrict__ src, float* __restrict__ dst,
                                      const float* __restrict__ rot, WarpParams p) {
  const int x0 = blockIdx.x * blockDim.x * GROUP<1> + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int t = blockIdx.z;
  if (x0 >= p.out_w || y >= p.out_h) return;
  const RowMap row(p, rot + t * 9, y);
  f32_group<1>(p, row, x0, src + (size_t)t * p.in_h * p.in_w,
               dst + ((size_t)t * p.out_h + y) * p.out_w, 0);
}

// One (in_h, in_w) float32 frame -> (gridDim.y * 8, out_w) float32: block
// row b renders global tile row min(b + off, ny - 1), all 8 of its rows.
__global__ void warp_f32_band_kernel(const float* __restrict__ src, float* __restrict__ dst,
                                     const float* __restrict__ rot, WarpParams p, int ny,
                                     int off) {
  const int x0 = blockIdx.x * blockDim.x * GROUP<1> + threadIdx.x;
  const int y = blockIdx.y * blockDim.y + threadIdx.y;
  const int gy = min((int)blockIdx.y + off, ny - 1) * TILE_ROWS + (int)threadIdx.y;
  if (x0 >= p.out_w) return;
  const RowMap row(p, rot, gy);
  f32_group<1>(p, row, x0, src, dst + (size_t)y * p.out_w, 0);
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
  if (nplanes != 1 || ny != 0 || t < 1 || !plane_fits(in_h, in_w, 1))
    return static_cast<int>(cudaErrorInvalidValue);
  warp_kernel<1, false, DIAG><<<group_grid(t, GROUP<1>, out_h, out_w), dim3(32, TILE_ROWS),
                                0, static_cast<cudaStream_t>(stream)>>>(
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
  if (ny < 0 || !plane_fits(in_h, in_w, 1)) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(32, TILE_ROWS);
  const dim3 grid = group_grid(t, group_of(nplanes), out_h, out_w);
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
  if (ny < 0 || t < 1 || (t > 1 && (nplanes != 1 || ny != 0)) ||
      !plane_fits(in_h, in_w, sizeof(float)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(32, TILE_ROWS);
  const dim3 grid = group_grid(t, group_of(t > 1 ? 1 : nplanes), out_h, out_w);
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
  if (ny_band < 1 || off < 0 || !plane_fits(in_h, in_w, sizeof(float)))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(32, TILE_ROWS);
  const dim3 grid = group_grid(1, GROUP<1>, ny_band * TILE_ROWS, out_w);
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
