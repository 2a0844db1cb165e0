// Flash-attention forward for Hopper (sm_90a): bf16 in and out, fp32 accumulation.
//
// Replaces the Pallas TPU kernel `_fwd_kernel` (dualforce_tpu/ops/flash_attention.py:132)
// in both of its modes, with or without the LSE output. Per (batch, head) it computes
//     O = softmax(Q K^T / sqrt(D) + mask) V,
// non-causal, D = 128, with keys at positions >= kv_len[b] excluded. As on the TPU, the
// running max is floored at -1e4 (log2 units) and a row whose softmax denominator is 0
// (every key masked) writes zeros instead of NaN. When `lse` is given it also writes the
// natural-log LSE of each row, [B, N, Sq] fp32: (m + log2 l) * ln 2 in the kernel's log2
// units, with l = 0 taken as 1, so a row with no valid key gets -1e4 * ln 2 (the backward
// kernel's input; serving passes no `lse` and writes nothing more).
//
// Cap mode (the TPU kernel's `cap` branch, :166-173, and its LSE epilogue, :200; the
// dispatcher's "fast" route): softmax is shift-invariant, so a static shift `cap` (log2
// units) replaces the running max. P = exp2(s - cap) with no row max, no alpha and no rescale
// of the row sum and the accumulator; o = acc / l (l == 0 gives 0) and LSE = (cap + log2 l)
// * ln 2, so a row with no valid key gets cap * ln 2. Exact while the row's largest score lies
// in (cap - 126, cap + 127), which MOVA's QK RMS-norm keeps it in. It is a compile-time
// variant (kCap) of the same kernel, chosen by the C entry's `cap_mode` flag.
//
// What bounds it on an H100: at the main path's sequence lengths it is bound by tensor-core
// operations, not bytes. Video self-attention at 43,120 tokens does 4*Sq*Sk*D flops against
// 2*(2*Sq + 2*Sk)*D bytes, ~21,000 flops per byte, far above the card's ~295 (989 TF/s bf16
// over 3.35 TB/s). Only the short audio-side calls (403 queries over 403 or 512 keys) are
// bound by bytes and launch latency.
//
// Design, simple first: each CTA (4 warps) owns 64 query rows of one (batch, head); each
// warp owns 16 of them. Q is loaded once into shared memory and then held in registers as
// mma fragments. K and V stream through shared memory in 64-key tiles with cp.async; the
// next K tile loads while P.V runs and V loads while Q.K^T runs. Q.K^T and P.V run on bf16
// mma.sync m16n8k16 with fp32 accumulators; the online softmax state (row max, row sum)
// stays in registers, and scores are scaled by D^-1/2 * log2(e) in fp32 before exp2.
// Tensors are read as [B, S, N, D] through their strides (no transpose copy), and ragged
// q and k tiles are masked in the kernel (no padding copy): 43,120 and 403 are not
// multiples of 64. Work stops at the last key tile that holds a valid key, so a short
// kv_len costs only the tiles it needs. wgmma/TMA and warp specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 128;
constexpr int kBlockM = 64;
constexpr int kBlockN = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
// Padded shared-memory row (bf16 elements): a 272-byte stride puts the 8 rows that one
// ldmatrix phase reads on 8 distinct 16-byte bank groups.
constexpr int kSmemLd = kHeadDim + 8;
constexpr int kSmemBytes = (kBlockM + 2 * kBlockN) * kSmemLd * 2;
constexpr float kMaxFloor = -1.0e4f;  // running-max floor, log2 units (the TPU kernel's)
constexpr float kLn2 = 0.6931471805599453f;

static_assert(kBlockM == kWarps * 16, "one 16-row mma tile per warp");

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte asynchronous copy from global to shared memory; zero-fills when !valid.
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(dst)),
               "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}

// c += a * b for one m16n8k16 tile: a is 16x16 row-major, b is 16x8 column-major.
__device__ __forceinline__ void mma_16816(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats to a bf16 pair; the lower-indexed element goes in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Stage rows [row0, row0 + 64) of a [rows, 128] strided view into shared memory; rows at or
// past `rows_valid` are zero-filled (never read from global memory).
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem, const __nv_bfloat16* gmem,
                                          int64_t row_stride, int row0, int rows_valid,
                                          int tid) {
  constexpr int kChunksPerRow = kHeadDim / 8;  // 16-byte chunks
#pragma unroll
  for (int i = 0; i < kBlockN * kChunksPerRow / kThreads; ++i) {
    const int chunk = tid + i * kThreads;
    const int r = chunk / kChunksPerRow;
    const int c = (chunk % kChunksPerRow) * 8;
    const int row = row0 + r;
    const bool valid = row < rows_valid;
    const __nv_bfloat16* src = gmem + static_cast<int64_t>(valid ? row : 0) * row_stride + c;
    cp_async_16(smem + r * kSmemLd + c, src, valid);
  }
}

template <bool kCap>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, const int* __restrict__ kv_len, int heads,
                     int sq, int sk, int64_t q_sb,
                     int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                     int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss,
                     int64_t o_sh, float scale_log2, float cap) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_k = s_q + kBlockM * kSmemLd;
  __nv_bfloat16* s_v = s_k + kBlockN * kSmemLd;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int b = blockIdx.y / heads;
  const int h = blockIdx.y % heads;
  const int m0 = blockIdx.x * kBlockM;

  int n_keys = sk;
  if (kv_len != nullptr) n_keys = max(0, min(kv_len[b], sk));
  const int n_blocks = (n_keys + kBlockN - 1) / kBlockN;

  q += b * q_sb + h * q_sh;
  k += b * k_sb + h * k_sh;
  v += b * v_sb + h * v_sh;
  o += b * o_sb + h * o_sh;

  float acc[kHeadDim / 8][4];
#pragma unroll
  for (int dt = 0; dt < kHeadDim / 8; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[dt][c] = 0.f;
  // Per thread: rows (lane / 4) and (lane / 4 + 8) of the warp's 16-row tile.
  float row_max[2] = {-1.0e30f, -1.0e30f};
  float row_sum[2] = {0.f, 0.f};  // this thread's partial sums; reduced over the quad at the end
  uint32_t q_frag[kHeadDim / 16][4];

  if (n_blocks > 0) {
    load_tile(s_q, q, q_ss, m0, sq, tid);
    load_tile(s_k, k, k_ss, 0, n_keys, tid);
  }
  cp_async_commit();

  for (int j = 0; j < n_blocks; ++j) {
    load_tile(s_v, v, v_ss, j * kBlockN, n_keys, tid);
    cp_async_commit();
    cp_async_wait<1>();  // Q (first pass) and K_j have landed; V_j may still be in flight
    __syncthreads();

    if (j == 0) {
#pragma unroll
      for (int ks = 0; ks < kHeadDim / 16; ++ks)
        ldsm_x4(q_frag[ks], s_q + (warp * 16 + (lane % 16)) * kSmemLd + ks * 16 + (lane / 16) * 8);
    }

    // S = Q K^T for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys).
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kHeadDim / 16; ++ks) {
#pragma unroll
      for (int np = 0; np < kBlockN / 16; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, s_k + (np * 16 + (lane % 8) + (lane / 16) * 8) * kSmemLd + ks * 16 +
                        ((lane / 8) % 2) * 8);
        mma_16816(s[2 * np], q_frag[ks], kb[0], kb[1]);
        mma_16816(s[2 * np + 1], q_frag[ks], kb[2], kb[3]);
      }
    }
    __syncthreads();  // every warp is done with s_k
    if (j + 1 < n_blocks) load_tile(s_k, k, k_ss, (j + 1) * kBlockN, n_keys, tid);
    cp_async_commit();  // possibly empty: keeps the group count uniform

    // Online softmax in exp2 units.
    const bool ragged = (j + 1) * kBlockN > n_keys;
    const int key0 = j * kBlockN + (lane % 4) * 2;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[nt][c] * scale_log2;
        if (ragged && key0 + nt * 8 + (c % 2) >= n_keys) x = -INFINITY;
        s[nt][c] = x;
      }
    }
    if constexpr (kCap) {
      // static shift: masked keys are -inf and give exact zeros
#pragma unroll
      for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[nt][c] = exp2f(s[nt][c] - cap);
          row_sum[c / 2] += s[nt][c];
        }
      }
    } else {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = -INFINITY;
#pragma unroll
        for (int nt = 0; nt < kBlockN / 8; ++nt) mx = fmaxf(mx, fmaxf(s[nt][2 * r], s[nt][2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(fmaxf(row_max[r], mx), kMaxFloor);
        const float alpha = exp2f(row_max[r] - m_new);
        row_max[r] = m_new;
        row_sum[r] *= alpha;
#pragma unroll
        for (int dt = 0; dt < kHeadDim / 8; ++dt) {
          acc[dt][2 * r] *= alpha;
          acc[dt][2 * r + 1] *= alpha;
        }
#pragma unroll
        for (int nt = 0; nt < kBlockN / 8; ++nt) {
          s[nt][2 * r] = exp2f(s[nt][2 * r] - m_new);
          s[nt][2 * r + 1] = exp2f(s[nt][2 * r + 1] - m_new);
          row_sum[r] += s[nt][2 * r] + s[nt][2 * r + 1];
        }
      }
    }

    cp_async_wait<1>();  // V_j has landed; K_{j+1} may still be in flight
    __syncthreads();

    // O += P V: P (bf16) comes straight from the score accumulators.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16x2(s[2 * kk][0], s[2 * kk][1]), pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kHeadDim / 16; ++dp) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, s_v + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * kSmemLd +
                              dp * 16 + (lane / 16) * 8);
        mma_16816(acc[2 * dp], pa, vb[0], vb[1]);
        mma_16816(acc[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with s_v before the next V tile lands there
  }
  cp_async_wait<0>();

  // Epilogue: normalise and store; a row with no valid key (sum 0) stores zeros.
  const int row_a = m0 + warp * 16 + lane / 4;
  const int row_b = row_a + 8;
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float total = row_sum[r];
    total += __shfl_xor_sync(0xffffffffu, total, 1);
    total += __shfl_xor_sync(0xffffffffu, total, 2);
    const float safe = total == 0.f ? 1.f : total;
    inv[r] = 1.f / safe;
    const int row = r == 0 ? row_a : row_b;
    // the floor also covers a row that saw no key tile at all (kv_len 0)
    const float shift = kCap ? cap : fmaxf(row_max[r], kMaxFloor);
    if (lse != nullptr && lane % 4 == 0 && row < sq)
      lse[static_cast<int64_t>(blockIdx.y) * sq + row] = (shift + log2f(safe)) * kLn2;
  }
#pragma unroll
  for (int dt = 0; dt < kHeadDim / 8; ++dt) {
    const int col = dt * 8 + (lane % 4) * 2;
    if (row_a < sq)
      *reinterpret_cast<uint32_t*>(o + row_a * o_ss + col) =
          pack_bf16x2(acc[dt][0] * inv[0], acc[dt][1] * inv[0]);
    if (row_b < sq)
      *reinterpret_cast<uint32_t*>(o + row_b * o_ss + col) =
          pack_bf16x2(acc[dt][2] * inv[1], acc[dt][3] * inv[1]);
  }
}

// The opt-in to more than 48 KiB of dynamic shared memory, made once per device and kernel
// variant, not on every launch (two threads racing here both set the same value).
template <bool kCap>
cudaError_t smem_opt_in() {
  constexpr int kMaxDevices = 64;
  static bool done[kMaxDevices] = {};
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && done[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(flash_fwd_kernel<kCap>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err == cudaSuccess && device < kMaxDevices) done[device] = true;
  return err;
}

}  // namespace

// Launches the kernel on `stream`. Strides are in elements, for [B, S, N, D] views with a
// unit D stride. lse is a device pointer to [B, N, Sq] fp32, or null for no LSE output.
// kv_len is a device pointer to [B] int32, or null for no key mask. A nonzero cap_mode runs
// the cap-mode variant with the static shift `cap` (log2 units); cap is unused otherwise.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int dft_flash_fwd_bf16(const void* q, const void* k, const void* v, void* o,
                                  void* lse, const void* kv_len, int batch, int heads, int sq,
                                  int sk, long long q_sb, long long q_ss, long long q_sh,
                                  long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                                  long long v_ss, long long v_sh, long long o_sb, long long o_ss,
                                  long long o_sh, float scale_log2, int cap_mode, float cap,
                                  void* stream) {
  const cudaError_t err = cap_mode ? smem_opt_in<true>() : smem_opt_in<false>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBlockM - 1) / kBlockM, batch * heads);
  auto kernel = cap_mode ? flash_fwd_kernel<true> : flash_fwd_kernel<false>;
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), static_cast<const int*>(kv_len), heads, sq, sk, q_sb, q_ss,
      q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, scale_log2, cap);
  return static_cast<int>(cudaGetLastError());
}
