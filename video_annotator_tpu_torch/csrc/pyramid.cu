// The LK pyramid's blur and decimation: one level down, for a whole chunk.
//
// Replaces no Pallas kernel. The JAX package builds each level with two
// banded float32 products, video_annotator_tpu/ops/lk.py::_pyr_down
// (:58-59, two lax.dot's with the matrices of _decim_matrix), which a TPU's
// matrix unit absorbs. On this card the same products run as two dense
// cuBLAS sgemms that spend up to H multiply-adds an output pixel on a
// 5-tap filter; this kernel does the 5 taps.
//
// (T, H, W) float32 -> (T, H/2, W/2) float32 (floor), in one launch. Values
// are those of dy @ img @ dx^T, dy and dx from _decim_matrix:
//   - row r of the matrix holds [1, 4, 6, 4, 1]/16 at 2r-2 .. 2r+2, the taps
//     that fall outside the level added onto its edge (11/16 on index 0 of
//     row 0); the kernel uses those merged entries, not clamped loads;
//   - the vertical pass first, rounded to float32, then the horizontal one,
//     as the two products;
//   - each pass accumulates with fmaf in ascending source index, from 0.
// Where the products are exact (sums of k/16 steps on uint8-derived values
// that fit 24 bits) any order gives the same float, so the result equals
// the banded products' bit for bit; ops/lk.py::pyr_down_plain repeats this
// order of operations exactly, for any input.
//
// Bound on Hopper: bytes. Each input byte is read once and each output byte
// written once (5 bytes a 4-byte output: 235 MB for a 17-frame 1920x1440
// chunk's level 1, 70 us at 3.35 TB/s); 10 fmaf an output is nothing beside
// that. A block owns 16 output rows by 64 output columns: each of its 128
// threads walks one input column down the tile's 35 source rows (coalesced,
// 128-byte aligned loads held in registers), writes the 16 vertical sums to
// shared memory, and after one barrier each thread forms 8 outputs from 5
// shared reads apiece. The 3 halo columns and 3 halo rows a tile reads
// again cost 2% and 9% of its input; the (T, H/2, W) intermediate never
// reaches device memory.

#include <cuda_runtime.h>

namespace {

constexpr int TILE_ROWS = 16;
constexpr int TILE_COLS = 64;
constexpr int THREADS = 2 * TILE_COLS;
constexpr int SPAN_ROWS = 2 * TILE_ROWS + 3;  // source rows of a tile
constexpr int SPAN_COLS = 2 * TILE_COLS + 3;  // source columns of a tile
constexpr int MAX_GRID_Z = 65535;

// Tap j of [1, 4, 6, 4, 1]/16, and the sums of taps 0..j: the entry of the
// matrix on index 0 (prefix) or, with 4 - j, on index n - 1 (suffix).
__device__ __forceinline__ float tap16(int j) {
  return j == 2 ? 0.375f : (j == 1 || j == 3) ? 0.25f : 0.0625f;
}

__device__ __forceinline__ float prefix16(int j) {
  return j == 0 ? 0.0625f : j == 1 ? 0.3125f : j == 2 ? 0.6875f : j == 3 ? 0.9375f : 1.0f;
}

// Entry of _decim_matrix(n) for source index s = 2r - 2 + j of row r: 0
// outside [0, n), the merged taps on an edge, else tap j.
__device__ __forceinline__ float entry(int j, int s, int n) {
  if (s < 0 || s >= n) return 0.0f;
  if (s == 0) return prefix16(j);
  if (s == n - 1) return prefix16(4 - j);
  return tap16(j);
}

// The tile's 16 vertical sums of one source column, from its 35 source rows
// (row indices clamped for the loads; a clamped row has entry 0 and is
// skipped). EDGE false: no row of the tile touches row 0 or row n - 1, so
// every entry is a plain tap and folds to a constant.
template <bool EDGE>
__device__ __forceinline__ void column_sums(const float* __restrict__ col, int stride,
                                            int y_first, int h, int r0,
                                            float* __restrict__ out, int out_stride) {
  float v[SPAN_ROWS];
#pragma unroll
  for (int k = 0; k < SPAN_ROWS; ++k) {
    const int y = min(max(y_first + k, 0), h - 1);
    v[k] = __ldg(col + (size_t)y * stride);
  }
#pragma unroll
  for (int r = 0; r < TILE_ROWS; ++r) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      const float e = EDGE ? entry(j, 2 * (r0 + r) - 2 + j, h) : tap16(j);
      if (e != 0.0f) acc = fmaf(e, v[2 * r + j], acc);
    }
    out[r * out_stride] = acc;
  }
}

__global__ void __launch_bounds__(THREADS)
pyr_down_kernel(const float* __restrict__ src, float* __restrict__ dst, int h, int w,
                int h2, int w2) {
  __shared__ float vert[TILE_ROWS][SPAN_COLS];
  const int c0 = blockIdx.x * TILE_COLS;
  const int r0 = blockIdx.y * TILE_ROWS;
  const size_t t = blockIdx.z;
  const float* plane = src + t * h * w;
  const int x_first = 2 * c0 - 2;  // source column of vert[.][0]
  const int y_first = 2 * r0 - 2;  // source row of the tile's first tap
  const bool edge = y_first < 1 || y_first + SPAN_ROWS - 1 > h - 2;

  // Vertical pass. Threads 0..127 take the aligned columns 2c0 .. 2c0+127
  // (vert columns 2..129), threads 0..2 then the halo columns 130, 0, 1.
  // A column outside the level is never read by the horizontal pass.
  for (int i = threadIdx.x; i < SPAN_COLS; i += THREADS) {
    const int l = (i + 2) % SPAN_COLS;
    const int x = x_first + l;
    if (x < 0 || x >= w) continue;
    if (edge) {
      column_sums<true>(plane + x, w, y_first, h, r0, &vert[0][l], SPAN_COLS);
    } else {
      column_sums<false>(plane + x, w, y_first, h, r0, &vert[0][l], SPAN_COLS);
    }
  }
  __syncthreads();

  // Horizontal pass: column c of the output, rows lane/64, +2, ... .
  const int cl = threadIdx.x % TILE_COLS;
  const int c = c0 + cl;
  if (c >= w2) return;
  float e[5];
#pragma unroll
  for (int j = 0; j < 5; ++j) e[j] = entry(j, 2 * c - 2 + j, w);
  const int rows = min(TILE_ROWS, h2 - r0);
  float* out = dst + (t * h2 + r0) * w2 + c;
  for (int r = threadIdx.x / TILE_COLS; r < rows; r += THREADS / TILE_COLS) {
    float acc = 0.0f;
#pragma unroll
    for (int j = 0; j < 5; ++j) {
      if (e[j] != 0.0f) acc = fmaf(e[j], vert[r][2 * cl + j], acc);
    }
    out[(size_t)r * w2] = acc;
  }
}

}  // namespace

// (t, h, w) float32 src -> (t, h/2, w/2) float32 dst, both contiguous, on
// the stream; the caller launches only for a non-empty dst.
extern "C" int vat_pyr_down(const void* src, void* dst, int t, int h, int w,
                            void* stream) {
  const int h2 = h / 2, w2 = w / 2;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const size_t in_plane = (size_t)h * w, out_plane = (size_t)h2 * w2;
  for (int t0 = 0; t0 < t; t0 += MAX_GRID_Z) {
    const dim3 grid((w2 + TILE_COLS - 1) / TILE_COLS, (h2 + TILE_ROWS - 1) / TILE_ROWS,
                    t - t0 < MAX_GRID_Z ? t - t0 : MAX_GRID_Z);
    pyr_down_kernel<<<grid, THREADS, 0, s>>>(
        static_cast<const float*>(src) + t0 * in_plane,
        static_cast<float*>(dst) + t0 * out_plane, h, w, h2, w2);
  }
  return static_cast<int>(cudaGetLastError());
}
