// Wahba's problem for a batch of 3x3 correlations, in one launch: the
// proper rotation R maximising tr(R B^T) by the Davenport q-method.
//
// Replaces no Pallas kernel. The JAX package solves it in plain XLA,
// video_annotator_tpu/so3.py::rotation_from_correlation (:174), whose
// 120-step shifted power loop XLA fuses for the TPU. Run eagerly, the same
// loop costs five tiny PyTorch launches a step (product, sum, norm, add,
// divide), about 680 a call for two 4x4 eigenproblems a matrix; RANSAC's
// refinement calls it twice a chunk (ops/ransac.py::estimate_rotation).
// This kernel does the whole function in registers, one thread a matrix,
// both starts stepped side by side.
//
// (m, 3, 3) float32 B -> (m, 3, 3) float32 R, both contiguous. The order
// of operations is so3.py::rotation_from_correlation_plain's, each step
// rounded once (__fmul_rn / __fadd_rn / __fsub_rn / __fdiv_rn /
// __fsqrt_rn, so no multiply-add is contracted):
//   - K from B's entries as the plain function forms them, the shift
//     2 |B|_F + 1e-6 with the nine squares summed from index 0 up;
//   - the starts: all ones, and the one-hot at the first largest entry of
//     K's diagonal;
//   - each step v <- Ks v / (|Ks v| + 1e-8): each row's four products
//     summed from index 0 up, the norm the root of the squares summed from
//     index 0 up;
//   - both Rayleigh quotients v . (K v) summed the same way, the first
//     start kept where its quotient is >= the second's, then the
//     quaternion's rotation matrix.
// PyTorch's reduce kernels may sum in another order, so the kernel and
// the plain function on the card agree to rounding, not bit for bit.
//
// Bound on Hopper: latency, not bytes or operations. A call of 16
// matrices moves 1.2 KB and does about 160 000 float operations
// (nanoseconds at the card's peaks), but each thread runs a chain of 120
// dependent steps, each a 4x4 product, a correctly rounded root and four
// correctly rounded divisions (multi-instruction sequences), on one warp
// with nothing to hide their latency: 0.044 ms a call on an H100 SXM at
// 700 W, queued, against 1.79 ms of card time for the eager chain.

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 128;
constexpr float EPS = 1e-8f;
constexpr float SHIFT_EPS = 1e-6f;

__device__ __forceinline__ float mul(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ float add(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ float sub(float a, float b) { return __fsub_rn(a, b); }

// Row i of m times v: the four products summed from index 0 up.
__device__ __forceinline__ float row_dot(const float m[4][4], int i, const float v[4]) {
  float acc = mul(m[i][0], v[0]);
#pragma unroll
  for (int j = 1; j < 4; ++j) acc = add(acc, mul(m[i][j], v[j]));
  return acc;
}

// One step of the power loop: v <- ks v / (|ks v| + 1e-8).
__device__ __forceinline__ void power_step(const float ks[4][4], float v[4]) {
  float u[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) u[i] = row_dot(ks, i, v);
  float ss = mul(u[0], u[0]);
#pragma unroll
  for (int i = 1; i < 4; ++i) ss = add(ss, mul(u[i], u[i]));
  const float n = add(__fsqrt_rn(ss), EPS);
#pragma unroll
  for (int i = 0; i < 4; ++i) v[i] = __fdiv_rn(u[i], n);
}

__device__ __forceinline__ float rayleigh(const float k[4][4], const float v[4]) {
  float acc = mul(v[0], row_dot(k, 0, v));
#pragma unroll
  for (int i = 1; i < 4; ++i) acc = add(acc, mul(v[i], row_dot(k, i, v)));
  return acc;
}

__global__ void __launch_bounds__(THREADS)
wahba_kernel(const float* __restrict__ bs, float* __restrict__ rs, int m, int iters) {
  const int idx = blockIdx.x * THREADS + threadIdx.x;
  if (idx >= m) return;
  float b[3][3];
#pragma unroll
  for (int i = 0; i < 9; ++i) b[i / 3][i % 3] = bs[(size_t)idx * 9 + i];

  const float z1 = sub(b[2][1], b[1][2]);
  const float z2 = sub(b[0][2], b[2][0]);
  const float z3 = sub(b[1][0], b[0][1]);
  const float s01 = add(b[0][1], b[1][0]);
  const float s02 = add(b[0][2], b[2][0]);
  const float s12 = add(b[1][2], b[2][1]);
  const float k[4][4] = {
      {add(add(b[0][0], b[1][1]), b[2][2]), z1, z2, z3},
      {z1, sub(sub(b[0][0], b[1][1]), b[2][2]), s01, s02},
      {z2, s01, sub(sub(b[1][1], b[0][0]), b[2][2]), s12},
      {z3, s02, s12, sub(sub(b[2][2], b[0][0]), b[1][1])},
  };

  float fro = mul(b[0][0], b[0][0]);
#pragma unroll
  for (int i = 1; i < 9; ++i) fro = add(fro, mul(b[i / 3][i % 3], b[i / 3][i % 3]));
  const float shift = add(mul(2.0f, __fsqrt_rn(fro)), SHIFT_EPS);
  float ks[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) ks[i][j] = i == j ? add(k[i][i], shift) : k[i][j];
  }

  // The pivot: the first largest diagonal entry (a NaN counts as largest).
  int pivot = 0;
  float best = k[0][0];
#pragma unroll
  for (int i = 1; i < 4; ++i) {
    if (!isnan(best) && (k[i][i] > best || isnan(k[i][i]))) {
      pivot = i;
      best = k[i][i];
    }
  }
  float v0[4], v1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    v0[i] = 1.0f;
    v1[i] = i == pivot ? 1.0f : 0.0f;
  }
  for (int it = 0; it < iters; ++it) {
    power_step(ks, v0);
    power_step(ks, v1);
  }
  const bool first = rayleigh(k, v0) >= rayleigh(k, v1);
  float q[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = first ? v0[i] : v1[i];

  // so3.py::quat_to_matrix, term by term.
  const float w = q[0], x = q[1], y = q[2], z = q[3];
  const float xx = mul(x, x), yy = mul(y, y), zz = mul(z, z);
  const float xy = mul(x, y), xz = mul(x, z), yz = mul(y, z);
  const float wx = mul(w, x), wy = mul(w, y), wz = mul(w, z);
  const float r[9] = {
      sub(1.0f, mul(2.0f, add(yy, zz))), mul(2.0f, sub(xy, wz)), mul(2.0f, add(xz, wy)),
      mul(2.0f, add(xy, wz)), sub(1.0f, mul(2.0f, add(xx, zz))), mul(2.0f, sub(yz, wx)),
      mul(2.0f, sub(xz, wy)), mul(2.0f, add(yz, wx)), sub(1.0f, mul(2.0f, add(xx, yy))),
  };
#pragma unroll
  for (int i = 0; i < 9; ++i) rs[(size_t)idx * 9 + i] = r[i];
}

}  // namespace

// (m, 3, 3) float32 b -> (m, 3, 3) float32 r, both contiguous, on the
// stream; the caller launches only for m > 0.
extern "C" int vat_wahba(const void* b, void* r, int m, int iters, void* stream) {
  wahba_kernel<<<(m + THREADS - 1) / THREADS, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(b), static_cast<float*>(r), m, iters);
  return static_cast<int>(cudaGetLastError());
}
