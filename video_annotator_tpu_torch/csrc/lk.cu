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
// Bound on Hopper: latency. A point's work is small (441 template
// elements, 8 Newton iterations of a bilinear resample and two sums) and
// every iteration depends on the last; the per-frame form has 200 points.
// At one warp per point, 4 points per block, each lane re-read its 14
// elements' four bytes through Window::at's clamp, range test and 64-bit
// index per iteration (56 dependent loads), and the per-frame launch was
// 50 blocks on 132 SMs.
//
// Design: the next frame's 48 x 256 window, the whole of what the
// iterations can read, is copied once per point into shared memory
// (cp.async, 16 bytes a copy, rows padded to 288 bytes so that the two or
// three template rows a warp reads fall in distinct banks), as the TPU
// kernel fetched it once. The copy runs while the template is built from
// the prev frame. The iterations then read shared memory without clamps:
// the drift clamp keeps oy in [1, 24] and ox in [1, 233], so every read
// lies in rows [1, 45] and columns [1, 254] of the window (pinned by
// tests/test_torch_lk_reach.py on the plain version). The template's
// reads keep Window::at's clamps, since they may leave the window. A
// point takes TPP threads, 128 or 64, chosen per launch from m
// (threads_per_point): few points spread over more threads. Each thread
// owns ceil(441 / TPP) template elements in registers. Sums reduce with
// xor shuffles inside each warp, then through per-warp partials in shared
// memory, double-buffered by iteration so one barrier an iteration
// suffices; every thread adds the partials in the same order, so the
// Newton update is uniform across the point's threads. On an H100 (700 W)
// at level 0 of the main paths this takes the per-frame launch (200
// points) to 0.28 of the one-warp-a-point kernel and the pairs launch
// (3200) to 0.52 (tools/time_warp_builds.py, both sources timed in
// turns); both now sit near the card's launch floor. Copying the 22 x 22
// neighbourhood an iteration reads, every iteration, took 1.31 and 1.35
// times as long.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WIN = 21;
constexpr int NEL = WIN * WIN;             // 441 template elements
constexpr int TROWS = WIN + 3;             // 24 bilinear template rows (halo)
constexpr int TCOLS = WIN + 2;             // 23 template columns (halo)
constexpr int WROWS = 48;                  // window rows (12 words x 4)
constexpr int WCOLS = 256;                 // window columns (2 strips)
constexpr int SPITCH = WCOLS + 32;         // shared bytes per window row
constexpr float Y_HI = 4 * 12 - WIN - 3;   // 24
constexpr float X_HI = WCOLS - WIN - 2;    // 233
constexpr float MIN_EIG_THRESHOLD = 1e-4f;
constexpr int BLOCK = 128;                 // threads per block

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

// The shared state of the points of one block.
template <int TPP>
struct Shared {
  static constexpr int POINTS = BLOCK / TPP;
  static constexpr int WARPS = TPP / 32;
  uint8_t win[POINTS][WROWS * SPITCH];     // the next window, 16-byte rows
  float rows[POINTS][TROWS * TCOLS];       // the bilinear template rows
  float part[POINTS][2][WARPS][3];         // per-warp partial sums
};

// The N sums of a point's TPP threads, the same value in each of them.
// `buf` alternates between calls, so one barrier a call suffices.
template <int TPP, int N>
__device__ __forceinline__ void point_sum(float (&v)[N], float (&part)[2][TPP / 32][3],
                                          int buf, int tid) {
#pragma unroll
  for (int n = 0; n < N; ++n) v[n] = warp_sum(v[n]);
  if ((tid & 31) == 0) {
#pragma unroll
    for (int n = 0; n < N; ++n) part[buf][tid >> 5][n] = v[n];
  }
  __syncthreads();
#pragma unroll
  for (int n = 0; n < N; ++n) {
    float s = part[buf][0][n];
#pragma unroll
    for (int w = 1; w < TPP / 32; ++w) s += part[buf][w][n];
    v[n] = s;
  }
}

// prev/next: the staged levels the prev and next windows are read from
// (the same stack for the pairs form); pi's rows and columns are relative
// to them. TPP threads per point, BLOCK / TPP points per block.
template <int TPP>
__global__ void __launch_bounds__(BLOCK) lk_level_kernel(
    const uint8_t* __restrict__ prev_base, const uint8_t* __restrict__ next_base, int pitch,
    const float* __restrict__ pf, const int* __restrict__ pi, float* __restrict__ out, int m,
    int iters) {
  constexpr int PER = (NEL + TPP - 1) / TPP;  // template elements per thread
  extern __shared__ __align__(16) uint8_t smem[];
  Shared<TPP>& sh = *reinterpret_cast<Shared<TPP>*>(smem);
  const int slot = threadIdx.x / TPP;
  const int tid = threadIdx.x % TPP;
  // A slot past the last point repeats it and writes nothing, so every
  // thread of the block reaches the barriers.
  const int point = (int)blockIdx.x * Shared<TPP>::POINTS + slot;
  const bool live = point < m;
  const int i = min(point, m - 1);

  const float gx0 = pf[i * 6 + 0], gy0 = pf[i * 6 + 1];
  const float ryp = pf[i * 6 + 2], ixp = pf[i * 6 + 3];
  const float ryn = pf[i * 6 + 4], ixn = pf[i * 6 + 5];
  const Window prev{prev_base + (size_t)pi[i * 4 + 0] * pitch + pi[i * 4 + 1], pitch};
  const uint8_t* next = next_base + (size_t)pi[i * 4 + 2] * pitch + pi[i * 4 + 3];

  // The next window into shared memory, 16 bytes a copy, in flight while
  // the template is built.
  uint8_t* win = sh.win[slot];
  for (int c = tid; c < WROWS * WCOLS / 16; c += TPP) {
    const int y = c / (WCOLS / 16), x = (c % (WCOLS / 16)) * 16;
    __pipeline_memcpy_async(win + y * SPITCH + x, next + (size_t)y * pitch + x, 16);
  }
  __pipeline_commit();

  // Template rows: rows[k][l] = image at (ryp + k, ixp - 1 + l), bilinear,
  // x blended first (as the TPU kernel's sample_rows), then y.
  float* rows = sh.rows[slot];
  {
    const int iy = floor_index(ryp);
    const float fy = ryp - floorf(ryp);
    const float ix = ixp - 1.0f;
    const int ixi = floor_index(ix);
    const float fx = ix - floorf(ix);
    for (int e = tid; e < TROWS * TCOLS; e += TPP) {
      const int k = e / TCOLS, l = e % TCOLS;
      const int y = iy + k, x = ixi + l;
      const float s0 = prev.at(y, x) * (1.0f - fx) + prev.at(y, x + 1) * fx;
      const float s1 = prev.at(y + 1, x) * (1.0f - fx) + prev.at(y + 1, x + 1) * fx;
      rows[e] = s0 * (1.0f - fy) + s1 * fy;
    }
  }
  __pipeline_wait_prior(0);
  __syncthreads();

  float tpl[PER], gxr[PER], gyr[PER];
  int woff[PER];  // the element's byte in the window, from the iteration's corner
  float g[3] = {0.0f, 0.0f, 0.0f};  // sum gx gx, gx gy, gy gy
#pragma unroll
  for (int j = 0; j < PER; ++j) {
    const int e = tid + TPP * j;
    tpl[j] = gxr[j] = gyr[j] = 0.0f;
    woff[j] = 0;
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
      woff[j] = k * SPITCH + l;
      g[0] += gx * gx;
      g[1] += gx * gy;
      g[2] += gy * gy;
    }
  }
  point_sum<TPP>(g, sh.part[slot], 0, tid);
  const float gxx = g[0], gxy = g[1], gyy = g[2];
  const float det = gxx * gyy - gxy * gxy;
  const float trace = gxx + gyy;
  const float min_eig = (trace - sqrtf(fmaxf(trace * trace - 4.0f * det, 0.0f))) * 0.5f;
  const float inv_det = fabsf(det) > 1e-12f ? 1.0f / det : 0.0f;

  float vx = gx0, vy = gy0;
  for (int it = 0; it < iters; ++it) {
    // The clamps keep every read in rows [1, 45] and columns [1, 254].
    const float oy = fminf(fmaxf((ryn + 1.0f) + (vy - gy0), 1.0f), Y_HI);
    const float ox = fminf(fmaxf(ixn + (vx - gx0), 1.0f), X_HI);
    const int iy = (int)floorf(oy), ixi = (int)floorf(ox);
    const float fy = oy - floorf(oy), fx = ox - floorf(ox);
    const uint8_t* w = win + iy * SPITCH + ixi;
    float b[2] = {0.0f, 0.0f};
#pragma unroll
    for (int j = 0; j < PER; ++j) {
      if (tid + TPP * j < NEL) {
        const uint8_t* q = w + woff[j];
        const float c0 = (float)q[0] * (1.0f - fx) + (float)q[1] * fx;
        const float c1 = (float)q[SPITCH] * (1.0f - fx) + (float)q[SPITCH + 1] * fx;
        const float r = (c0 * (1.0f - fy) + c1 * fy) - tpl[j];
        b[0] += r * gxr[j];
        b[1] += r * gyr[j];
      }
    }
    point_sum<TPP>(b, sh.part[slot], (it + 1) & 1, tid);
    vx -= (gyy * b[0] - gxy * b[1]) * inv_det;
    vy -= (gxx * b[1] - gxy * b[0]) * inv_det;
  }

  if (live && tid == 0) {
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

// Threads per point for a launch of m points: 128 while one block a point
// fills the card at most twice over, else 64 (two points a block). On an
// H100 at the main paths' shapes 128 took 0.0074 ms for 200 points against
// 0.0088 with 64, and 64 took 0.0318 ms for 3200 against 0.0334 with 128
// (32: 0.0119, 0.0413; tools/time_warp_builds.py).
int threads_per_point(int m) { return m <= 2 * 132 * 4 ? 128 : 64; }

template <int TPP>
int launch_tpp(const uint8_t* prev, const uint8_t* next, int pitch, const float* pf,
               const int* pi, float* out, int m, int iters, cudaStream_t stream) {
  constexpr int points = BLOCK / TPP;
  const int bytes = static_cast<int>(sizeof(Shared<TPP>));
  cudaError_t err = cudaFuncSetAttribute(lk_level_kernel<TPP>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  lk_level_kernel<TPP><<<(m + points - 1) / points, BLOCK, bytes, stream>>>(
      prev, next, pitch, pf, pi, out, m, iters);
  return static_cast<int>(cudaGetLastError());
}

int launch(const void* prev, const void* next, int pitch, const void* pf,
           const void* pi, void* out, int m, int iters, void* stream) {
  if (m <= 0) return 0;
  // The window copies take 16-byte aligned rows.
  if (pitch % 16 != 0 || reinterpret_cast<uintptr_t>(next) % 16 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto* p = static_cast<const uint8_t*>(prev);
  const auto* n = static_cast<const uint8_t*>(next);
  const auto* f = static_cast<const float*>(pf);
  const auto* k = static_cast<const int*>(pi);
  auto* o = static_cast<float*>(out);
  auto s = static_cast<cudaStream_t>(stream);
  return threads_per_point(m) == 128 ? launch_tpp<128>(p, n, pitch, f, k, o, m, iters, s)
                                     : launch_tpp<64>(p, n, pitch, f, k, o, m, iters, s);
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
