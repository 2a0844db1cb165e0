// Int8-QK ("sage") attention forward for Hopper (sm_90a): int8 Q and K, bf16 V and output,
// fp32 softmax.
//
// Replaces the Pallas TPU kernel `_sage_fwd_kernel` (dualforce_tpu/ops/flash_attention.py:731),
// launched by `_sage_fwd` (:787) behind `sage_attention` (:857); inference only. The
// quantization prologue (K mean-centred over the sequence, per-block absmax int8 for Q and
// K, the softmax scale and log2(e) folded into the q scales) runs in plain PyTorch before
// it, as JAX runs it in XLA before the Pallas call. Per (batch, head) the kernel computes
//     s = float(Qi8 . Ki8^T) * (q_scale[row] * k_scale[key])      (log2 units)
//     P = exp2(s - cap),  o = (P V) / rowsum(P)
// with keys at positions >= kv_len[b] excluded and a row whose sum is 0 (no valid key, or
// every score underflowing) written as exact zeros. The scales arrive as per-row [B, N, Sq]
// and per-key [B, N, Sk] fp32 vectors, expanded by the caller from the TPU kernel's block
// scales, so this kernel's tiles are free of the quantization blocks (1232 and 1960 rows at
// 360p video self-attention, multiples of no tile used here). There is no running max: like
// the TPU kernel, sage takes the static shift `cap` only (QK-RMS-normed scores are bounded):
// kCap, the value of FAST_SOFTMAX_CAP in ops/flash_attention.py, fixed at compile time.
//
// What bounds it on an H100: at the main path's long sequences it is bound by tensor-core
// operations: 2*Sq*Sk*D int8 operations (at 1,979 TOP/s) for Q.K^T plus 2*Sq*Sk*D bf16 flops
// (at 989 TF/s) for P.V, 28.87 ms for 40 heads at 43,120^2 against the bf16 forward's 38.50;
// its bytes (int8 q and k, bf16 v and o, the fp32 scale vectors) are a small fraction of
// that. Only the short audio-side calls are bound by bytes and launch latency.
//
// Design, simple first, on the exact forward's skeleton (csrc/flash_fwd.cu): one CTA of 4
// warps per 64 query rows of one (batch, head), 16 rows per warp. Q (int8) is loaded once into
// shared memory and held in registers as mma fragments; K (int8, half the bytes of a bf16
// tile) and V (bf16) stream through shared memory in 64-key tiles with cp.async, the next K
// tile loading during P.V and V during Q.K^T. Q.K^T runs on mma.sync m16n8k32 s8.s8->s32,
// P.V on bf16 mma.sync m16n8k16 with fp32 accumulators. Ragged q and k tiles are masked in
// the kernel; work stops at the last key tile that holds a valid key. Left for later: wgmma
// with int8 operands and TMA loads (the mma.sync path cannot reach the int8 peak), and fusing
// the quantization prologue (two extra passes over q and k in device memory).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 128;
constexpr int kBlockM = 64;
constexpr int kBlockN = 64;
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr float kCap = 30.f;  // the static softmax shift, log2 units (FAST_SOFTMAX_CAP)
// Padded shared-memory rows: 144 bytes for an int8 row and 272 bytes (136 bf16) for a V row,
// so the 8 rows one ldmatrix phase reads sit on 8 distinct 16-byte bank groups.
constexpr int kLdI8 = kHeadDim + 16;
constexpr int kLdV = kHeadDim + 8;
constexpr int kSmemBytes =
    (kBlockM + kBlockN) * kLdI8 + kBlockN * kLdV * 2 + kBlockN * static_cast<int>(sizeof(float));

static_assert(kBlockM == kWarps * 16, "one 16-row mma tile per warp");
static_assert(kSmemBytes <= 48 * 1024, "fits the default dynamic shared memory");

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

// c += a * b for one m16n8k32 int8 tile: a is 16x32 row-major, b is 32x8 column-major.
__device__ __forceinline__ void mma_s8_16832(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                             uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// c += a * b for one m16n8k16 bf16 tile: a is 16x16 row-major, b is 16x8 column-major.
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

// Stage rows [row0, row0 + 64) of a [rows, 128] int8 strided view into shared memory; rows
// at or past `rows_valid` are zero-filled (never read from global memory).
__device__ __forceinline__ void load_tile_i8(int8_t* smem, const int8_t* gmem,
                                             int64_t row_stride, int row0, int rows_valid,
                                             int tid) {
  constexpr int kChunksPerRow = kHeadDim / 16;  // 16-byte chunks
#pragma unroll
  for (int i = 0; i < kBlockN * kChunksPerRow / kThreads; ++i) {
    const int chunk = tid + i * kThreads;
    const int r = chunk / kChunksPerRow;
    const int c = (chunk % kChunksPerRow) * 16;
    const int row = row0 + r;
    const bool valid = row < rows_valid;
    const int8_t* src = gmem + static_cast<int64_t>(valid ? row : 0) * row_stride + c;
    cp_async_16(smem + r * kLdI8 + c, src, valid);
  }
}

// The same for a [rows, 128] bf16 view.
__device__ __forceinline__ void load_tile_bf16(__nv_bfloat16* smem, const __nv_bfloat16* gmem,
                                               int64_t row_stride, int row0, int rows_valid,
                                               int tid) {
  constexpr int kChunksPerRow = kHeadDim / 8;
#pragma unroll
  for (int i = 0; i < kBlockN * kChunksPerRow / kThreads; ++i) {
    const int chunk = tid + i * kThreads;
    const int r = chunk / kChunksPerRow;
    const int c = (chunk % kChunksPerRow) * 8;
    const int row = row0 + r;
    const bool valid = row < rows_valid;
    const __nv_bfloat16* src = gmem + static_cast<int64_t>(valid ? row : 0) * row_stride + c;
    cp_async_16(smem + r * kLdV + c, src, valid);
  }
}

// The per-key scales of keys [key0, key0 + 64) into shared memory, 0 past `n_keys`. Plain
// loads: a [B, N, Sk] fp32 row is 16-byte aligned only when Sk % 4 == 0 (403 is not).
__device__ __forceinline__ void load_key_scales(float* smem, const float* k_scale, int key0,
                                                int n_keys, int tid) {
  if (tid < kBlockN) smem[tid] = key0 + tid < n_keys ? k_scale[key0 + tid] : 0.f;
}

__global__ void __launch_bounds__(kThreads)
    sage_fwd_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ k,
                    const __nv_bfloat16* __restrict__ v, __nv_bfloat16* __restrict__ o,
                    const float* __restrict__ q_scale, const float* __restrict__ k_scale,
                    const int* __restrict__ kv_len, int heads, int sq, int sk, int64_t q_sb,
                    int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                    int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t o_sb, int64_t o_ss,
                    int64_t o_sh) {
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* s_q = reinterpret_cast<int8_t*>(smem);
  int8_t* s_k = s_q + kBlockM * kLdI8;
  __nv_bfloat16* s_v = reinterpret_cast<__nv_bfloat16*>(s_k + kBlockN * kLdI8);
  float* s_ks = reinterpret_cast<float*>(s_v + kBlockN * kLdV);

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
  q_scale += static_cast<int64_t>(blockIdx.y) * sq;
  k_scale += static_cast<int64_t>(blockIdx.y) * sk;

  // Per thread: rows (lane / 4) and (lane / 4 + 8) of the warp's 16-row tile.
  const int row_a = m0 + warp * 16 + lane / 4;
  const int row_b = row_a + 8;
  const float qs[2] = {row_a < sq ? q_scale[row_a] : 0.f, row_b < sq ? q_scale[row_b] : 0.f};

  float acc[kHeadDim / 8][4];
#pragma unroll
  for (int dt = 0; dt < kHeadDim / 8; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[dt][c] = 0.f;
  float row_sum[2] = {0.f, 0.f};  // this thread's partial sums; reduced over the quad at the end
  uint32_t q_frag[kHeadDim / 32][4];

  if (n_blocks > 0) {
    load_tile_i8(s_q, q, q_ss, m0, sq, tid);
    load_tile_i8(s_k, k, k_ss, 0, n_keys, tid);
    load_key_scales(s_ks, k_scale, 0, n_keys, tid);
  }
  cp_async_commit();

  for (int j = 0; j < n_blocks; ++j) {
    load_tile_bf16(s_v, v, v_ss, j * kBlockN, n_keys, tid);
    cp_async_commit();
    cp_async_wait<1>();  // Q (first pass) and K_j have landed; V_j may still be in flight
    __syncthreads();

    if (j == 0) {
#pragma unroll
      for (int ks = 0; ks < kHeadDim / 32; ++ks)
        ldsm_x4(q_frag[ks], s_q + (warp * 16 + (lane % 16)) * kLdI8 + ks * 32 + (lane / 16) * 16);
    }

    // S = Q K^T in int32 for this warp's 16 rows x 64 keys (8 n-tiles of 8 keys).
    int si[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) si[nt][c] = 0;
#pragma unroll
    for (int ks = 0; ks < kHeadDim / 32; ++ks) {
#pragma unroll
      for (int np = 0; np < kBlockN / 16; ++np) {
        uint32_t kb[4];
        ldsm_x4(kb, s_k + (np * 16 + (lane % 8) + (lane / 16) * 8) * kLdI8 + ks * 32 +
                        ((lane / 8) % 2) * 16);
        mma_s8_16832(si[2 * np], q_frag[ks], kb[0], kb[1]);
        mma_s8_16832(si[2 * np + 1], q_frag[ks], kb[2], kb[3]);
      }
    }

    // Dequantise in log2 units, as the TPU kernel: float(s) * (q_scale * k_scale); masked
    // keys are -inf. The key scales are read before the barrier below frees s_ks.
    const bool ragged = (j + 1) * kBlockN > n_keys;
    float s[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = nt * 8 + (lane % 4) * 2 + (c % 2);
        float x = __int2float_rn(si[nt][c]) * (qs[c / 2] * s_ks[col]);
        if (ragged && j * kBlockN + col >= n_keys) x = -INFINITY;
        s[nt][c] = x;
      }
    }
    __syncthreads();  // every warp is done with s_k and s_ks
    if (j + 1 < n_blocks) {
      load_tile_i8(s_k, k, k_ss, (j + 1) * kBlockN, n_keys, tid);
      load_key_scales(s_ks, k_scale, (j + 1) * kBlockN, n_keys, tid);
    }
    cp_async_commit();  // possibly empty: keeps the group count uniform

    // Static-shift softmax numerator and this thread's row sums.
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[nt][c] = exp2f(s[nt][c] - kCap);
        row_sum[c / 2] += s[nt][c];
      }
    }

    cp_async_wait<1>();  // V_j has landed; K_{j+1} may still be in flight
    __syncthreads();

    // O += P V: P (bf16) comes straight from the score registers.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint32_t pa[4] = {
          pack_bf16x2(s[2 * kk][0], s[2 * kk][1]), pack_bf16x2(s[2 * kk][2], s[2 * kk][3]),
          pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]),
          pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dp = 0; dp < kHeadDim / 16; ++dp) {
        uint32_t vb[4];
        ldsm_x4_trans(vb, s_v + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * kLdV +
                              dp * 16 + (lane / 16) * 8);
        mma_16816(acc[2 * dp], pa, vb[0], vb[1]);
        mma_16816(acc[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // every warp is done with s_v before the next V tile lands there
  }
  cp_async_wait<0>();

  // Epilogue: normalise and store; a row whose sum is 0 stores zeros.
  float inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float total = row_sum[r];
    total += __shfl_xor_sync(0xffffffffu, total, 1);
    total += __shfl_xor_sync(0xffffffffu, total, 2);
    inv[r] = 1.f / (total == 0.f ? 1.f : total);
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

}  // namespace

// Launches the kernel on `stream`. q and k are int8 and v and o bf16 [B, S, N, 128] views with
// a unit D stride; strides are in elements. q_scale is [B, N, Sq] and k_scale [B, N, Sk] fp32,
// contiguous; q_scale already holds D^-1/2 * log2(e). kv_len is a device pointer to [B] int32,
// or null for no key mask.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int dft_sage_fwd(const void* q, const void* k, const void* v, void* o,
                            const void* q_scale, const void* k_scale, const void* kv_len,
                            int batch, int heads, int sq, int sk, long long q_sb, long long q_ss,
                            long long q_sh, long long k_sb, long long k_ss, long long k_sh,
                            long long v_sb, long long v_ss, long long v_sh, long long o_sb,
                            long long o_ss, long long o_sh, void* stream) {
  const dim3 grid((sq + kBlockM - 1) / kBlockM, batch * heads);
  sage_fwd_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(q), static_cast<const int8_t*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<const float*>(q_scale), static_cast<const float*>(k_scale),
      static_cast<const int*>(kv_len), heads, sq, sk, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb,
      v_ss, v_sh, o_sb, o_ss, o_sh);
  return static_cast<int>(cudaGetLastError());
}
