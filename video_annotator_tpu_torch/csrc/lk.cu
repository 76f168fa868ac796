// K2: one Lucas-Kanade pyramid level for every point of every frame pair.
//
// Replaces the TPU LK kernel video_annotator_tpu/ops/lk_pallas.py
// (_make_lk_kernel :73-263) in both of its launches: all pairs of a chunk
// stacked in one level (_lk_level_pallas_pairs, pallas_call :624; entry
// vat_lk_level) and one pair of separately staged frames
// (_lk_level_pallas, pallas_call :366; entry vat_lk_level_frame). Per point:
//   - a 21x21 template sampled bilinearly at the point from the prev
//     frame, with a 1-pixel halo, and its Scharr (3,10,3)/32 gradients;
//   - G = sum [gx gx, gx gy; gx gy, gy gy], gated by min_eig/441 > 1e-4;
//   - `iters` Newton steps v -= G^-1 sum (I_next(p + v) - T) grad T on the
//     next frame.
// Both frames are uint8-rounded levels staged by K3 (stage.cu). The TPU
// kernel fetched one 48-row x 256-column window per frame, once, around
// p (prev) and p + guess (next); drift is clamped to that window and the
// status cleared where the clamp bites (:212-257). The host computes the
// same window origins (ops/lk_kernel.py::origins) and passes them here, so
// the clamp and the status are the TPU kernel's exactly; samples outside
// the window's 256 columns read 0, as there.
//
// Bound on Hopper: latency of the dependent per-iteration gathers
// (4 bytes per template element per iteration, 8 iterations) and the
// warp reductions between iterations; the arithmetic is small. Design:
// one warp per point, 4 points per 128-thread block. Each lane owns 14 of
// the 441 template elements and keeps their template value and gradients
// in registers; the bilinear template rows are built once in shared
// memory; sums reduce with xor shuffles, which leave the identical total
// in every lane, so the Newton update is uniform across the warp and no
// block-level barrier is needed.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WIN = 21;
constexpr int NEL = WIN * WIN;            // 441 template elements
constexpr int PER_LANE = (NEL + 31) / 32;  // 14
constexpr int TROWS = WIN + 3;             // 24 bilinear template rows (halo)
constexpr int TCOLS = WIN + 2;             // 23 template columns (halo)
constexpr int WROWS = 48;                  // window rows (12 words x 4)
constexpr int WCOLS = 256;                 // window columns (2 strips)
constexpr float Y_HI = 4 * 12 - WIN - 3;   // 24
constexpr float X_HI = WCOLS - WIN - 2;    // 233
constexpr float MIN_EIG_THRESHOLD = 1e-4f;
constexpr int POINTS_PER_BLOCK = 4;

struct Window {
  const uint8_t* base;  // window row 0, column 0
  int pitch;            // bytes per stack row
  __device__ __forceinline__ float at(int y, int x) const {
    // Rows stay inside the window (the host guarantees the window is
    // inside its band); columns beyond the window read 0 like the TPU
    // kernel's masked lane gather.
    y = min(max(y, 0), WROWS - 1);
    return (x >= 0 && x < WCOLS) ? (float)__ldg(base + (size_t)y * pitch + x) : 0.0f;
  }
};

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ int floor_index(float v) {
  // Keep garbage coordinates of failed points finite for the int cast.
  return (int)floorf(fminf(fmaxf(v, -1024.0f), 1024.0f));
}

// prev/next: the staged levels the prev and next windows are read from
// (the same stack for the pairs form); pi's rows and columns are relative
// to them.
__global__ void lk_level_kernel(const uint8_t* __restrict__ prev_base,
                                const uint8_t* __restrict__ next_base, int pitch,
                                const float* __restrict__ pf,
                                const int* __restrict__ pi,
                                float* __restrict__ out, int m, int iters) {
  __shared__ float rows_s[POINTS_PER_BLOCK][TROWS * TCOLS];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int i = blockIdx.x * POINTS_PER_BLOCK + warp;
  if (i >= m) return;  // whole warp leaves together

  const float gx0 = pf[i * 6 + 0], gy0 = pf[i * 6 + 1];
  const float ryp = pf[i * 6 + 2], ixp = pf[i * 6 + 3];
  const float ryn = pf[i * 6 + 4], ixn = pf[i * 6 + 5];
  const Window prev{prev_base + (size_t)pi[i * 4 + 0] * pitch + pi[i * 4 + 1], pitch};
  const Window next{next_base + (size_t)pi[i * 4 + 2] * pitch + pi[i * 4 + 3], pitch};

  // Template rows: rows[k][l] = image at (ryp + k, ixp - 1 + l), bilinear,
  // x blended first (as the TPU kernel's sample_rows), then y.
  float* rows = rows_s[warp];
  {
    const int iy = floor_index(ryp);
    const float fy = ryp - floorf(ryp);
    const float ix = ixp - 1.0f;
    const int ixi = floor_index(ix);
    const float fx = ix - floorf(ix);
    for (int e = lane; e < TROWS * TCOLS; e += 32) {
      const int k = e / TCOLS, l = e % TCOLS;
      const int y = iy + k, x = ixi + l;
      const float s0 = prev.at(y, x) * (1.0f - fx) + prev.at(y, x + 1) * fx;
      const float s1 = prev.at(y + 1, x) * (1.0f - fx) + prev.at(y + 1, x + 1) * fx;
      rows[e] = s0 * (1.0f - fy) + s1 * fy;
    }
  }
  __syncwarp();

  float tpl[PER_LANE], gxr[PER_LANE], gyr[PER_LANE];
  float sxx = 0.0f, sxy = 0.0f, syy = 0.0f;
#pragma unroll
  for (int j = 0; j < PER_LANE; ++j) {
    const int e = lane + 32 * j;
    tpl[j] = gxr[j] = gyr[j] = 0.0f;
    if (e < NEL) {
      const int k = e / WIN, l = e % WIN;
      const float* t = rows + k * TCOLS + l;
      const float* mrow = t + TCOLS;
      const float* b = mrow + TCOLS;
      const float gx = (3.0f * (t[2] - t[0]) + 10.0f * (mrow[2] - mrow[0]) +
                        3.0f * (b[2] - b[0])) / 32.0f;
      const float gy = (3.0f * (b[0] - t[0]) + 10.0f * (b[1] - t[1]) +
                        3.0f * (b[2] - t[2])) / 32.0f;
      tpl[j] = mrow[1];
      gxr[j] = gx;
      gyr[j] = gy;
      sxx += gx * gx;
      sxy += gx * gy;
      syy += gy * gy;
    }
  }
  const float gxx = warp_sum(sxx), gxy = warp_sum(sxy), gyy = warp_sum(syy);
  const float det = gxx * gyy - gxy * gxy;
  const float trace = gxx + gyy;
  const float min_eig = (trace - sqrtf(fmaxf(trace * trace - 4.0f * det, 0.0f))) * 0.5f;
  const float inv_det = fabsf(det) > 1e-12f ? 1.0f / det : 0.0f;

  float vx = gx0, vy = gy0;
  for (int it = 0; it < iters; ++it) {
    const float oy = fminf(fmaxf((ryn + 1.0f) + (vy - gy0), 1.0f), Y_HI);
    const float ox = fminf(fmaxf(ixn + (vx - gx0), 1.0f), X_HI);
    const int iy = (int)floorf(oy), ixi = (int)floorf(ox);
    const float fy = oy - floorf(oy), fx = ox - floorf(ox);
    float bx = 0.0f, by = 0.0f;
#pragma unroll
    for (int j = 0; j < PER_LANE; ++j) {
      const int e = lane + 32 * j;
      if (e < NEL) {
        const int k = e / WIN, l = e % WIN;
        const int y = iy + k, x = ixi + l;
        const float c0 = next.at(y, x) * (1.0f - fx) + next.at(y, x + 1) * fx;
        const float c1 = next.at(y + 1, x) * (1.0f - fx) + next.at(y + 1, x + 1) * fx;
        const float r = (c0 * (1.0f - fy) + c1 * fy) - tpl[j];
        bx += r * gxr[j];
        by += r * gyr[j];
      }
    }
    bx = warp_sum(bx);
    by = warp_sum(by);
    vx -= (gyy * bx - gxy * by) * inv_det;
    vy -= (gxx * by - gxy * bx) * inv_det;
  }

  if (lane == 0) {
    const float oy_want = (ryn + 1.0f) + (vy - gy0);
    const float ox_want = ixn + (vx - gx0);
    const bool unsat = oy_want >= 1.0f && oy_want <= Y_HI && ox_want >= 1.0f &&
                       ox_want <= X_HI;
    const bool ok = (min_eig / (float)NEL > MIN_EIG_THRESHOLD) && unsat;
    out[i * 3 + 0] = vx;
    out[i * 3 + 1] = vy;
    out[i * 3 + 2] = ok ? 1.0f : 0.0f;
  }
}

int launch(const void* prev, const void* next, int pitch, const void* pf,
           const void* pi, void* out, int m, int iters, void* stream) {
  if (m <= 0) return 0;
  const dim3 block(32 * POINTS_PER_BLOCK);
  const dim3 grid((m + POINTS_PER_BLOCK - 1) / POINTS_PER_BLOCK);
  lk_level_kernel<<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(prev), static_cast<const uint8_t*>(next), pitch,
      static_cast<const float*>(pf), static_cast<const int*>(pi),
      static_cast<float*>(out), m, iters);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// pf: (m, 6) f32 = guess x, guess y, ry prev, ix prev, ry next, ix next.
// pi: (m, 4) i32 = prev window row, prev window col, next row, next col.
// out: (m, 3) f32 = flow x, flow y, ok.

// Pairs form. stack: (rows, pitch) uint8 level stack of all frames' bands;
// pi's rows are absolute rows of the stack.
extern "C" int vat_lk_level(const void* stack, int pitch, const void* pf,
                            const void* pi, void* out, int m, int iters,
                            void* stream) {
  return launch(stack, stack, pitch, pf, pi, out, m, iters, stream);
}

// Per-frame form. prev, next: two (rows, pitch) uint8 staged levels of one
// shape; pi's prev rows index prev, its next rows index next.
extern "C" int vat_lk_level_frame(const void* prev, const void* next, int pitch,
                                  const void* pf, const void* pi, void* out, int m,
                                  int iters, void* stream) {
  return launch(prev, next, pitch, pf, pi, out, m, iters, stream);
}
