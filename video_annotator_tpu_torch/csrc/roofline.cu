// Rows 11 and 12 of the TPU kernel table: the two probes of the roofline
// tool, rebuilt for Hopper.
//
// Replaces benchmarks/roofline.py
//   _fma_kernel :86 (pallas_call :97)     -> fma_chain_kernel<UNROLL, FUSED>
//   _gather_kernel :113 (pallas_call :148) -> gather_visit_kernel<UNROLL>
//
// Both take (n, 8, 128) tensors, one block of 1024 threads per (8, 128)
// tile and one thread per element; n = 1 is the TPU kernel's function.
// Each thread runs `outer` iterations of UNROLL steps (the TPU kernel's
// fori_loop; its OUTER is a module constant, here an argument), so the
// slope between two UNROLL values cancels the launch and the loop's own
// cost. One tile is one SM's rate: 32 warps, 8 on each of its four
// schedulers, enough to cover the 4-cycle latency of a dependent float
// operation. n tiles with n >= 2 x 132 keep two 1024-thread blocks on
// every SM of an H100 at once: the card-wide rate. The TPU had one core;
// the port measures both.
//
// fma_chain_kernel: acc = acc * 0.999999 + x, starting from acc = x.
// Bound by operations. With FUSED = false the product and the sum are
// __fmul_rn and __fadd_rn, each rounded, as K1 computes its map and taps
// (csrc/warp_common.cuh) and as its plain PyTorch version does: two
// dependent instructions a step, so at most half the card's 67 TFLOP/s
// float32 peak, which counts a fused multiply-add as two operations. With
// FUSED = true the step is one __fmaf_rn: what K1's unfused choice costs.
//
// gather_visit_kernel: one "row visit" of the TPU warp's schedule walk per
// step: row (i * UNROLL + u) % 8 of the tile's int32 words, two gathers
// from it (lane idx and (idx + 1) & 127, each zero where its index is not
// below 128), bytes 0 and 1 of each word, and two weighted sums with
// wy0 = idx * 0.001 and fy = 1 - wy0, unfused; the output a0 + a1. The
// words are read from device memory through the read-only cache (__ldg),
// the path by which K1's taps read their source bytes (csrc/warp.cu,
// Taps::sample). A tile is 4 KB and stays in L1, so the rate measured is
// that of the read-only cache for word gathers scattered inside a 512-byte
// row: the rate K1's gathers pay. Hopper has no lane gather, and a table
// in shared memory would measure something K1 does not do.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE = 8 * 128;
constexpr float DECAY = 0.999999f;

template <int UNROLL, bool FUSED>
__global__ void __launch_bounds__(TILE)
    fma_chain_kernel(const float* __restrict__ x, float* __restrict__ out, int outer) {
  const size_t i = (size_t)blockIdx.x * TILE + threadIdx.x;
  const float xi = x[i];
  float acc = xi;
#pragma unroll 1
  for (int k = 0; k < outer; ++k) {
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      acc = FUSED ? __fmaf_rn(acc, DECAY, xi) : __fadd_rn(__fmul_rn(acc, DECAY), xi);
    }
  }
  out[i] = acc;
}

// `zero` is 0 at every launch. Added to each outer iteration's row base
// as (k & zero), it makes the addresses depend on k, so that no compiler
// pass can prove a load loop-invariant (with UNROLL = 8 step u reads row u
// in every iteration) and hoist it out of the loop.
template <int UNROLL>
__global__ void __launch_bounds__(TILE)
    gather_visit_kernel(const int* __restrict__ seg, const int* __restrict__ idx,
                        float* __restrict__ out, int outer, int zero) {
  const size_t i = (size_t)blockIdx.x * TILE + threadIdx.x;
  const int* tile = seg + (size_t)blockIdx.x * TILE;
  const int l0 = idx[i];
  const int l1 = (l0 + 1) & 127;
  const bool m0 = (unsigned)l0 < 128u;
  const bool m1 = (unsigned)(l0 + 1) < 128u;
  const float wy0 = __fmul_rn((float)l0, 0.001f);
  const float fy = __fsub_rn(1.0f, wy0);
  float a0 = 0.0f, a1 = 0.0f;
#pragma unroll 1
  for (int k = 0; k < outer; ++k) {
    const int* base = tile + (k & zero);
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      const int* row = base + ((k * UNROLL + u) & 7) * 128;
      const int g0 = m0 ? __ldg(row + l0) : 0;
      const int g1 = m1 ? __ldg(row + l1) : 0;
      const float v00 = (float)(g0 & 0xFF);
      const float v01 = (float)((g0 >> 8) & 0xFF);
      const float v10 = (float)(g1 & 0xFF);
      const float v11 = (float)((g1 >> 8) & 0xFF);
      a0 = __fadd_rn(a0, __fadd_rn(__fmul_rn(wy0, v00), __fmul_rn(fy, v01)));
      a1 = __fadd_rn(a1, __fadd_rn(__fmul_rn(wy0, v10), __fmul_rn(fy, v11)));
    }
  }
  out[i] = __fadd_rn(a0, a1);
}

}  // namespace

// (n, 8, 128) float32 x -> (n, 8, 128) float32; unroll 8 or 64.
extern "C" int vat_fma_chain(const void* x, void* out, int n, int unroll, int fused,
                             int outer, void* stream) {
  if (n < 1 || outer < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* in = static_cast<const float*>(x);
  float* o = static_cast<float*>(out);
  if (unroll == 8 && !fused) fma_chain_kernel<8, false><<<n, TILE, 0, s>>>(in, o, outer);
  else if (unroll == 64 && !fused) fma_chain_kernel<64, false><<<n, TILE, 0, s>>>(in, o, outer);
  else if (unroll == 8 && fused) fma_chain_kernel<8, true><<<n, TILE, 0, s>>>(in, o, outer);
  else if (unroll == 64 && fused) fma_chain_kernel<64, true><<<n, TILE, 0, s>>>(in, o, outer);
  else return static_cast<int>(cudaErrorInvalidValue);
  return static_cast<int>(cudaGetLastError());
}

// (n, 8, 128) int32 seg and idx -> (n, 8, 128) float32; unroll 2 or 8.
extern "C" int vat_gather_visits(const void* seg, const void* idx, void* out, int n,
                                 int unroll, int outer, void* stream) {
  if (n < 1 || outer < 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int* sg = static_cast<const int*>(seg);
  const int* ix = static_cast<const int*>(idx);
  float* o = static_cast<float*>(out);
  switch (unroll) {
    case 2: gather_visit_kernel<2><<<n, TILE, 0, s>>>(sg, ix, o, outer, 0); break;
    case 8: gather_visit_kernel<8><<<n, TILE, 0, s>>>(sg, ix, o, outer, 0); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
