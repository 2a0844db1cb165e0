// The combine of a forward split over keys, shared by the two forwards (flash_fwd.cu and
// sage_fwd.cu) and kept out of hopper.cuh so that the backward's library does not build it.

#pragma once

#include "hopper.cuh"

namespace {

// Merges the key ranges of a forward split over keys: one warp per row of [B * N * Sq], 4
// columns a lane. Range z left its unnormalised fp32 O in part_o [splits, rows, 128] and its
// row state (shift m, sum l) in part_ml [splits, rows, 2]: m = max m_i, l = sum l_i 2^(m_i - m),
// o = sum acc_i 2^(m_i - m) / l (l == 0 gives 0), and, where lse is not null, the natural-log
// LSE (m + log2 l) ln 2 with l == 0 taken as 1.
__global__ void split_combine_kernel(const float* __restrict__ part_o,
                                     const float* __restrict__ part_ml,
                                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                                     int heads, int sq, int splits, int64_t rows, int64_t o_sb,
                                     int64_t o_ss, int64_t o_sh) {
  const int64_t r = blockIdx.x * static_cast<int64_t>(blockDim.x / 32) + threadIdx.x / 32;
  if (r >= rows) return;
  const int lane = threadIdx.x % 32;
  float m = -INFINITY;
  for (int z = 0; z < splits; ++z) m = fmaxf(m, part_ml[(z * rows + r) * 2]);
  float l = 0.f;
  float4 a = make_float4(0.f, 0.f, 0.f, 0.f);
  for (int z = 0; z < splits; ++z) {
    const float2 ml = *reinterpret_cast<const float2*>(part_ml + (z * rows + r) * 2);
    const float w = exp2f(ml.x - m);
    const float4 x = *reinterpret_cast<const float4*>(part_o + (z * rows + r) * kHeadDim + 4 * lane);
    l += w * ml.y;
    a.x += w * x.x;
    a.y += w * x.y;
    a.z += w * x.z;
    a.w += w * x.w;
  }
  const float safe = l == 0.f ? 1.f : l;
  const float inv = 1.f / safe;
  const int64_t bh = r / sq;
  const int row = static_cast<int>(r % sq);
  __nv_bfloat16* dst =
      o + (bh / heads) * o_sb + row * o_ss + (bh % heads) * o_sh + 4 * lane;
  *reinterpret_cast<uint2*>(dst) =
      make_uint2(pack_bf16x2(a.x * inv, a.y * inv), pack_bf16x2(a.z * inv, a.w * inv));
  if (lse != nullptr && lane == 0) lse[r] = (m + log2f(safe)) * kLn2;
}

// Launches `split_combine_kernel` on `stream` over the B * N * Sq rows; o is written through its
// strides (in elements, a unit D stride). Returns the cudaError_t of the launch.
int launch_split_combine(const void* part_o, const void* part_ml, void* o, void* lse, int batch,
                         int heads, int sq, int splits, long long o_sb, long long o_ss,
                         long long o_sh, void* stream) {
  const int64_t rows = static_cast<int64_t>(batch) * heads * sq;
  const int warps = 8;
  const int64_t blocks = (rows + warps - 1) / warps;
  split_combine_kernel<<<static_cast<unsigned>(blocks), 32 * warps, 0,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(part_o), static_cast<const float*>(part_ml),
      static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse), heads, sq, splits, rows, o_sb,
      o_ss, o_sh);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
