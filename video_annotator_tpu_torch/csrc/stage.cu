// K3: stage a stack of planes or pyramid levels as padded uint8 rows.
//
// Replaces the TPU pack kernel video_annotator_tpu/ops/warp_pallas.py
// (_pack_kernel_body / _pack_call, reached by pack_frame_words) together
// with the rounding, padding and slack its callers add around it
// (pack_frame_words :1676-1690, lk_pack_pyramid_pairs :538-544). Only the
// value semantics carry over; the quad-row int32 word layout existed for
// the TPU's lane gather and is not reproduced.
//
// (T, H, W) float32 or uint8 -> (T, round_up(H,32) + slack, round_up(W,128))
// uint8:
//   - float input rounds half to even (rintf, like jnp.round) and clamps
//     to [0, 255]; uint8 input is copied;
//   - the alignment padding holds pad_value (0 luma / LK, 128 chroma);
//   - the slack rows repeat the last 4-row group of the padded plane
//     (the LK stack's 8 replicated bottom word rows).
//
// Bound on Hopper: pure memory traffic (4-5 bytes per output byte), no
// arithmetic to speak of. Each thread writes 4 adjacent output bytes as one
// uchar4 store; rows map to blockIdx.y so no division is needed per pixel.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint8_t to_u8(uint8_t v) { return v; }

__device__ __forceinline__ uint8_t to_u8(float v) {
  float r = fminf(fmaxf(rintf(v), 0.0f), 255.0f);
  return (uint8_t)(int)r;
}

template <typename T>
__global__ void stage_kernel(const T* __restrict__ src, uint8_t* __restrict__ dst,
                             int h, int w, int hp, int wp, int rows_out,
                             uint8_t pad) {
  const int x4 = (blockIdx.x * blockDim.x + threadIdx.x) * 4;
  const int y = blockIdx.y;
  const int t = blockIdx.z;
  if (x4 >= wp) return;
  const int sy = y < hp ? y : hp - 4 + ((y - hp) & 3);
  uint8_t v[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const int x = x4 + k;
    v[k] = (sy < h && x < w) ? to_u8(src[((size_t)t * h + sy) * w + x]) : pad;
  }
  *reinterpret_cast<uchar4*>(dst + ((size_t)t * rows_out + y) * wp + x4) =
      make_uchar4(v[0], v[1], v[2], v[3]);
}

}  // namespace

extern "C" const char* vat_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}

extern "C" int vat_stage_u8(const void* src, int src_is_float, void* dst, int t,
                            int h, int w, int hp, int wp, int slack,
                            int pad_value, void* stream) {
  const int rows_out = hp + slack;
  const dim3 block(128);
  const dim3 grid((wp / 4 + block.x - 1) / block.x, rows_out, t);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (src_is_float) {
    stage_kernel<float><<<grid, block, 0, s>>>(
        static_cast<const float*>(src), static_cast<uint8_t*>(dst), h, w, hp, wp,
        rows_out, static_cast<uint8_t>(pad_value));
  } else {
    stage_kernel<uint8_t><<<grid, block, 0, s>>>(
        static_cast<const uint8_t*>(src), static_cast<uint8_t*>(dst), h, w, hp,
        wp, rows_out, static_cast<uint8_t>(pad_value));
  }
  return static_cast<int>(cudaGetLastError());
}
