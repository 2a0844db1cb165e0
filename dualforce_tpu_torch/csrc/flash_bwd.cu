// Flash-attention backward for Hopper (sm_90a): bf16 in and out, fp32 accumulation.
//
// Replaces the Pallas TPU kernels of the backward (dualforce_tpu/ops/flash_attention.py): the
// one-pass `_bwd_fused_kernel` (:365), and the split pair that `_bwd_split` (:569) runs where
// the fused kernel's whole-row dQ scratch would pass its cap (720p, 176,400 tokens):
// `_bwd_dq_kernel` (:284) and `_bwd_dkv_kernel` (:321). From q, k, v, dO, the forward's
// natural-log LSE and delta = rowsum(dO * O) - dlse (computed outside, as `_bwd_prepare`
// does) both compute per (batch, head), non-causal, D = 128, with keys at positions
// >= kv_len[b] excluded:
//     P  = exp(Q K^T / sqrt(D) - lse)       dV = P^T dO
//     dP = dO V^T                           dS = P * (dP - delta)
//     dK = dS^T Q / sqrt(D)                 dQ = dS K / sqrt(D)
// Masked and ragged keys get exactly zero dK and dV; ragged query rows (past Sq) add
// nothing; a row with no valid key gets exactly zero dQ. P and dS are rounded to bf16 before
// their products, as on the TPU. Scores are scaled by D^-1/2 * log2(e) in fp32 before exp2
// (the TPU kernels fold the scale into a bf16 copy of q instead).
//
// What bounds them on an H100: at the training path's long shapes, tensor-core operations.
// Video self-attention does 10*Sq*Sk*D flops of useful products against 2*(4*Sq + 4*Sk)*D
// bytes of bf16 tensors, thousands of flops per byte, far above the card's ~295 (989 TF/s
// bf16 over 3.35 TB/s). The split pair recomputes S and dP in both passes: 14*Sq*Sk*D flops
// in all, 1.4 times the fused kernel's work, the price of a dQ without atomics.
//
// Fused design, simple first: each CTA (8 warps) owns one (batch, head) and a 64-key tile. It
// keeps K and V in shared memory and its dK and dV accumulators (64 x 128 fp32 each) in
// registers, split over the 8 warps as 16 keys x 64 columns, and loops over 64-row query
// tiles: Q, dO (cp.async), the tile's lse and delta. The warps first compute S = Q K^T and
// dP = dO V^T for 16 rows x 32 keys each, form P and dS in registers and stage them in shared
// memory as bf16; then each warp reads them back (ldmatrix, transposed where needed) for
// dV += P^T dO, dK += dS^T Q and dQ = dS K. All products are bf16 mma.sync m16n8k16 with fp32
// accumulators. The TPU kernel accumulates dQ over the key axis in a whole-row VMEM scratch
// because its grid runs in order; here the key tiles run in parallel on different SMs, so each
// CTA adds its dQ partial into a zeroed fp32 workspace [B, N, Sq, D] with atomicAdd, and a
// second small kernel scales it and casts it to bf16. The atomics make dQ's fp32 summation
// order, and so its last bits, vary from run to run; dK and dV are deterministic.
//
// Split design: the dk/dv pass is the fused kernel compiled without the dQ product, its
// atomics and the workspace (kDq = false), so its dK and dV are bit-equal to the fused
// kernel's. The dq pass (`flash_bwd_dq_kernel`) gives each CTA of 4 warps one (batch, head)
// and 64 query rows, 16 per warp: Q and dO stay in shared memory, lse and delta of the
// thread's two rows in registers, K and V stream through two shared-memory stages by
// cp.async; per key tile it forms S and dP, then P and dS in registers as the fused kernel
// does, and adds dS K into a 16 x 128 fp32 accumulator per warp, written once as bf16. So dq
// is deterministic, and the pair holds no fp32 workspace (3.6 GB at 720p video self-attention
// for the fused kernel). The tests hold dq, dk and dv within 2e-2 relative L2 of the fp32
// plain version on the same bf16 inputs (~2.4e-3 measured, the bf16 rounding of the outputs).
// Tensors are read and written as [B, S, N, D] through their strides, with 64-bit offsets.
// Ragged query and key tiles are zero-filled by cp.async and masked in the kernel (no padding
// copy). A key tile that lies wholly past kv_len[b] writes zeros and stops; the dq pass stops
// at the last key tile that holds a valid key. Later work: wgmma and TMA, double-buffered
// query tiles in the dk/dv pass, a dq pass that does not recompute S and dP.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 128;
constexpr int kBlockM = 64;   // query rows per inner step
constexpr int kBlockN = 64;   // keys per CTA
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
// Padded shared-memory rows (bf16 elements): 272 and 144 bytes put the 8 rows that one
// ldmatrix phase reads on distinct bank groups.
constexpr int kSmemLd = kHeadDim + 8;
constexpr int kPLd = kBlockN + 8;
constexpr int kTile = kBlockN * kSmemLd;  // one [64, 128] tile
constexpr int kSmemBytes = (4 * kTile + 2 * kBlockM * kPLd) * 2 + 2 * kBlockM * 4;
constexpr float kLog2e = 1.4426950408889634f;

static_assert(kBlockM == kBlockN, "the tile loader serves both");
static_assert(kWarps == 8, "warp roles below assume 4 row slices x 2 halves");

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
template <int kNThreads = kThreads>
__device__ __forceinline__ void load_tile(__nv_bfloat16* smem, const __nv_bfloat16* gmem,
                                          int64_t row_stride, int row0, int rows_valid,
                                          int tid) {
  constexpr int kChunksPerRow = kHeadDim / 8;  // 16-byte chunks
#pragma unroll
  for (int i = 0; i < kBlockN * kChunksPerRow / kNThreads; ++i) {
    const int chunk = tid + i * kNThreads;
    const int r = chunk / kChunksPerRow;
    const int c = (chunk % kChunksPerRow) * 8;
    const int row = row0 + r;
    const bool valid = row < rows_valid;
    const __nv_bfloat16* src = gmem + static_cast<int64_t>(valid ? row : 0) * row_stride + c;
    cp_async_16(smem + r * kSmemLd + c, src, valid);
  }
}

template <bool kDq>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v, const __nv_bfloat16* __restrict__ dout,
                     const float* __restrict__ lse, const float* __restrict__ delta,
                     const int* __restrict__ kv_len, float* __restrict__ dq_acc,
                     __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv, int heads,
                     int sq, int sk, int64_t q_sb, int64_t q_ss, int64_t q_sh, int64_t k_sb,
                     int64_t k_ss, int64_t k_sh, int64_t v_sb, int64_t v_ss, int64_t v_sh,
                     int64_t do_sb, int64_t do_ss, int64_t do_sh, int64_t dk_sb, int64_t dk_ss,
                     int64_t dk_sh, int64_t dv_sb, int64_t dv_ss, int64_t dv_sh, float scale_log2,
                     float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_k = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_v = s_k + kTile;
  __nv_bfloat16* s_q = s_v + kTile;
  __nv_bfloat16* s_do = s_q + kTile;
  __nv_bfloat16* s_p = s_do + kTile;
  __nv_bfloat16* s_ds = s_p + kBlockM * kPLd;
  float* s_lse = reinterpret_cast<float*>(s_ds + kBlockM * kPLd);  // log2 units
  float* s_delta = s_lse + kBlockM;

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;   // accumulator row within a 16-row mma tile (and row + 8)
  const int t = lane % 4;   // accumulator column pair within an 8-column mma tile
  const int slice = warp % 4;  // which 16 rows (query rows, or keys) a warp owns
  const int half = warp / 4;   // which half of the keys (32) or of the columns (64)
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int n0 = blockIdx.x * kBlockN;

  int n_keys = sk;
  if (kv_len != nullptr) n_keys = max(0, min(kv_len[b], sk));

  q += b * q_sb + h * q_sh;
  k += b * k_sb + h * k_sh;
  v += b * v_sb + h * v_sh;
  dout += b * do_sb + h * do_sh;
  dk += b * dk_sb + h * dk_sh;
  dv += b * dv_sb + h * dv_sh;
  lse += static_cast<int64_t>(bh) * sq;
  delta += static_cast<int64_t>(bh) * sq;
  if constexpr (kDq) dq_acc += static_cast<int64_t>(bh) * sq * kHeadDim;

  // dK and dV for keys n0 + slice*16 + {g, g+8}, columns half*64 + nt*8 + 2t + {0, 1}
  float acc_dk[8][4], acc_dv[8][4];
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc_dk[nt][c] = acc_dv[nt][c] = 0.f;

  if (n0 < n_keys) {
    load_tile(s_k, k, k_ss, n0, n_keys, tid);
    load_tile(s_v, v, v_ss, n0, n_keys, tid);
    cp_async_commit();
    const int n_q_tiles = (sq + kBlockM - 1) / kBlockM;
    for (int i = 0; i < n_q_tiles; ++i) {
      const int m0 = i * kBlockM;
      load_tile(s_q, q, q_ss, m0, sq, tid);
      load_tile(s_do, dout, do_ss, m0, sq, tid);
      cp_async_commit();
      if (tid < kBlockM) {
        const bool valid = m0 + tid < sq;
        s_lse[tid] = valid ? lse[m0 + tid] * kLog2e : 0.f;
        s_delta[tid] = valid ? delta[m0 + tid] : 0.f;
      }
      cp_async_wait<0>();
      __syncthreads();

      // S = Q K^T and dP = dO V^T for query rows slice*16.. and keys half*32.. (4 n-tiles).
      float s[4][4], dp[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[nt][c] = dp[nt][c] = 0.f;
#pragma unroll
      for (int ks = 0; ks < kHeadDim / 16; ++ks) {
        uint32_t qa[4], da[4];
        const int a_off = (slice * 16 + (lane % 16)) * kSmemLd + ks * 16 + (lane / 16) * 8;
        ldsm_x4(qa, s_q + a_off);
        ldsm_x4(da, s_do + a_off);
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          const int b_off = (half * 32 + np * 16 + (lane % 8) + (lane / 16) * 8) * kSmemLd +
                            ks * 16 + ((lane / 8) % 2) * 8;
          uint32_t kb[4], vb[4];
          ldsm_x4(kb, s_k + b_off);
          ldsm_x4(vb, s_v + b_off);
          mma_16816(s[2 * np], qa, kb[0], kb[1]);
          mma_16816(s[2 * np + 1], qa, kb[2], kb[3]);
          mma_16816(dp[2 * np], da, vb[0], vb[1]);
          mma_16816(dp[2 * np + 1], da, vb[2], vb[3]);
        }
      }

      // P = exp2(S * scale * log2 e - lse * log2 e), zero for ragged rows and masked keys;
      // dS = P * (dP - delta). Both go to shared memory as bf16.
      const int ra = slice * 16 + g;
      const int rb = ra + 8;
      const bool va = m0 + ra < sq, vb_ = m0 + rb < sq;
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int col = half * 32 + nt * 8 + 2 * t;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int r = c < 2 ? ra : rb;
          const bool keep = (c < 2 ? va : vb_) && n0 + col + (c % 2) < n_keys;
          const float p = keep ? exp2f(s[nt][c] * scale_log2 - s_lse[r]) : 0.f;
          s[nt][c] = p;
          dp[nt][c] = p * (dp[nt][c] - s_delta[r]);
        }
        *reinterpret_cast<uint32_t*>(s_p + ra * kPLd + col) = pack_bf16x2(s[nt][0], s[nt][1]);
        *reinterpret_cast<uint32_t*>(s_p + rb * kPLd + col) = pack_bf16x2(s[nt][2], s[nt][3]);
        *reinterpret_cast<uint32_t*>(s_ds + ra * kPLd + col) = pack_bf16x2(dp[nt][0], dp[nt][1]);
        *reinterpret_cast<uint32_t*>(s_ds + rb * kPLd + col) = pack_bf16x2(dp[nt][2], dp[nt][3]);
      }
      __syncthreads();

      // dV += P^T dO and dK += dS^T Q for keys slice*16.. and columns half*64.. .
#pragma unroll
      for (int kq = 0; kq < kBlockM / 16; ++kq) {
        uint32_t pa[4], dsa[4];
        const int t_off = (kq * 16 + (lane % 8) + (lane / 16) * 8) * kPLd + slice * 16 +
                          ((lane / 8) % 2) * 8;
        ldsm_x4_trans(pa, s_p + t_off);
        ldsm_x4_trans(dsa, s_ds + t_off);
#pragma unroll
        for (int dp2 = 0; dp2 < 4; ++dp2) {
          const int b_off = (kq * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * kSmemLd +
                            half * 64 + dp2 * 16 + (lane / 16) * 8;
          uint32_t ob[4], qb[4];
          ldsm_x4_trans(ob, s_do + b_off);
          ldsm_x4_trans(qb, s_q + b_off);
          mma_16816(acc_dv[2 * dp2], pa, ob[0], ob[1]);
          mma_16816(acc_dv[2 * dp2 + 1], pa, ob[2], ob[3]);
          mma_16816(acc_dk[2 * dp2], dsa, qb[0], qb[1]);
          mma_16816(acc_dk[2 * dp2 + 1], dsa, qb[2], qb[3]);
        }
      }

      // dQ partial = dS K for query rows slice*16.. and columns half*64.., added into the
      // fp32 workspace (the fused kernel only; the split's dk/dv pass stops here).
      if constexpr (kDq) {
        float dq[8][4];
#pragma unroll
        for (int nt = 0; nt < 8; ++nt)
#pragma unroll
          for (int c = 0; c < 4; ++c) dq[nt][c] = 0.f;
#pragma unroll
        for (int kk = 0; kk < kBlockN / 16; ++kk) {
          uint32_t a[4];
          ldsm_x4(a, s_ds + (slice * 16 + (lane % 16)) * kPLd + kk * 16 + (lane / 16) * 8);
#pragma unroll
          for (int dp2 = 0; dp2 < 4; ++dp2) {
            uint32_t kb[4];
            ldsm_x4_trans(kb, s_k + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * kSmemLd +
                                  half * 64 + dp2 * 16 + (lane / 16) * 8);
            mma_16816(dq[2 * dp2], a, kb[0], kb[1]);
            mma_16816(dq[2 * dp2 + 1], a, kb[2], kb[3]);
          }
        }
#pragma unroll
        for (int nt = 0; nt < 8; ++nt) {
          const int col = half * 64 + nt * 8 + 2 * t;
          if (va) {
            float* dst = dq_acc + static_cast<int64_t>(m0 + ra) * kHeadDim + col;
            atomicAdd(dst, dq[nt][0]);
            atomicAdd(dst + 1, dq[nt][1]);
          }
          if (vb_) {
            float* dst = dq_acc + static_cast<int64_t>(m0 + rb) * kHeadDim + col;
            atomicAdd(dst, dq[nt][2]);
            atomicAdd(dst + 1, dq[nt][3]);
          }
        }
      }
      __syncthreads();  // every warp is done with this query tile before the next lands
    }
  }

  // Epilogue: dK (scaled) and dV for this CTA's keys; masked keys store zeros.
  const int key_a = n0 + slice * 16 + g;
  const int key_b = key_a + 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = half * 64 + nt * 8 + 2 * t;
    if (key_a < sk) {
      *reinterpret_cast<uint32_t*>(dk + key_a * dk_ss + col) =
          pack_bf16x2(acc_dk[nt][0] * scale, acc_dk[nt][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + key_a * dv_ss + col) =
          pack_bf16x2(acc_dv[nt][0], acc_dv[nt][1]);
    }
    if (key_b < sk) {
      *reinterpret_cast<uint32_t*>(dk + key_b * dk_ss + col) =
          pack_bf16x2(acc_dk[nt][2] * scale, acc_dk[nt][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + key_b * dv_ss + col) =
          pack_bf16x2(acc_dv[nt][2], acc_dv[nt][3]);
    }
  }
}

// dQ = bf16(workspace * scale): the workspace is [B, N, Sq, 128] fp32, dq a strided
// [B, Sq, N, 128] view. Each thread converts 8 consecutive elements.
__global__ void dq_finish_kernel(const float* __restrict__ acc, __nv_bfloat16* __restrict__ dq,
                                 int heads, int sq, int64_t n_chunks, int64_t dq_sb,
                                 int64_t dq_ss, int64_t dq_sh, float scale) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n_chunks;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int col = static_cast<int>(i % (kHeadDim / 8)) * 8;
    const int64_t row_all = i / (kHeadDim / 8);
    const int row = static_cast<int>(row_all % sq);
    const int64_t bh = row_all / sq;
    const int b = static_cast<int>(bh / heads);
    const int h = static_cast<int>(bh % heads);
    const float4 lo = *reinterpret_cast<const float4*>(acc + i * 8);
    const float4 hi = *reinterpret_cast<const float4*>(acc + i * 8 + 4);
    uint4 out;
    out.x = pack_bf16x2(lo.x * scale, lo.y * scale);
    out.y = pack_bf16x2(lo.z * scale, lo.w * scale);
    out.z = pack_bf16x2(hi.x * scale, hi.y * scale);
    out.w = pack_bf16x2(hi.z * scale, hi.w * scale);
    *reinterpret_cast<uint4*>(dq + b * dq_sb + row * dq_ss + h * dq_sh + col) = out;
  }
}

// --- the split backward's dq pass --------------------------------------------------------
// One CTA of 4 warps per (batch, head) and 64-row query tile; each warp owns 16 rows and
// walks every key tile. Q and dO stay in shared memory, K and V stream through two stages
// (the next tile loads while this one is used), and dQ accumulates in registers.
constexpr int kDqWarps = 4;
constexpr int kDqThreads = kDqWarps * 32;
constexpr int kDqSmemBytes = 6 * kTile * 2;  // Q, dO and two stages of K and V

static_assert(kBlockM == kDqWarps * 16, "one 16-row mma tile per warp");

__global__ void __launch_bounds__(kDqThreads)
    flash_bwd_dq_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        const __nv_bfloat16* __restrict__ dout, const float* __restrict__ lse,
                        const float* __restrict__ delta, const int* __restrict__ kv_len,
                        __nv_bfloat16* __restrict__ dq, int heads, int sq, int sk, int64_t q_sb,
                        int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                        int64_t v_sb, int64_t v_ss, int64_t v_sh, int64_t do_sb, int64_t do_ss,
                        int64_t do_sh, int64_t dq_sb, int64_t dq_ss, int64_t dq_sh,
                        float scale_log2, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* s_q = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* s_do = s_q + kTile;
  __nv_bfloat16* s_kv = s_do + kTile;  // stage i: K at s_kv + 2 i kTile, V one tile after

  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int g = lane / 4;
  const int t = lane % 4;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int m0 = blockIdx.x * kBlockM;

  int n_keys = sk;
  if (kv_len != nullptr) n_keys = max(0, min(kv_len[b], sk));
  const int n_blocks = (n_keys + kBlockN - 1) / kBlockN;

  q += b * q_sb + h * q_sh;
  k += b * k_sb + h * k_sh;
  v += b * v_sb + h * v_sh;
  dout += b * do_sb + h * do_sh;
  dq += b * dq_sb + h * dq_sh;
  lse += static_cast<int64_t>(bh) * sq;
  delta += static_cast<int64_t>(bh) * sq;

  // This thread's rows: ra and rb = ra + 8 of the warp's 16. lse in log2 units; rows past Sq
  // read 0 (their Q and dO are zero-filled, so they add nothing, and they are not written).
  const int ra = m0 + warp * 16 + g;
  const int rb = ra + 8;
  const float lse_r[2] = {ra < sq ? lse[ra] * kLog2e : 0.f, rb < sq ? lse[rb] * kLog2e : 0.f};
  const float delta_r[2] = {ra < sq ? delta[ra] : 0.f, rb < sq ? delta[rb] : 0.f};

  // dQ for rows ra, rb and columns dt*8 + 2t + {0, 1}
  float acc[kHeadDim / 8][4];
#pragma unroll
  for (int dt = 0; dt < kHeadDim / 8; ++dt)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[dt][c] = 0.f;

  if (n_blocks > 0) {
    load_tile<kDqThreads>(s_q, q, q_ss, m0, sq, tid);
    load_tile<kDqThreads>(s_do, dout, do_ss, m0, sq, tid);
    load_tile<kDqThreads>(s_kv, k, k_ss, 0, n_keys, tid);
    load_tile<kDqThreads>(s_kv + kTile, v, v_ss, 0, n_keys, tid);
  }
  cp_async_commit();

  for (int j = 0; j < n_blocks; ++j) {
    const __nv_bfloat16* s_k = s_kv + (j % 2) * 2 * kTile;
    const __nv_bfloat16* s_v = s_k + kTile;
    if (j + 1 < n_blocks) {  // the other stage was freed by the barrier that ended step j - 1
      __nv_bfloat16* next = s_kv + ((j + 1) % 2) * 2 * kTile;
      load_tile<kDqThreads>(next, k, k_ss, (j + 1) * kBlockN, n_keys, tid);
      load_tile<kDqThreads>(next + kTile, v, v_ss, (j + 1) * kBlockN, n_keys, tid);
    }
    cp_async_commit();  // possibly empty: keeps the group count uniform
    cp_async_wait<1>();  // tile j (and, on the first step, Q and dO) has landed
    __syncthreads();

    // S = Q K^T and dP = dO V^T for the warp's 16 rows x 64 keys (8 n-tiles of 8 keys).
    float s[kBlockN / 8][4], dp[kBlockN / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[nt][c] = dp[nt][c] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kHeadDim / 16; ++ks) {
      uint32_t qa[4], da[4];
      const int a_off = (warp * 16 + (lane % 16)) * kSmemLd + ks * 16 + (lane / 16) * 8;
      ldsm_x4(qa, s_q + a_off);
      ldsm_x4(da, s_do + a_off);
#pragma unroll
      for (int np = 0; np < kBlockN / 16; ++np) {
        const int b_off =
            (np * 16 + (lane % 8) + (lane / 16) * 8) * kSmemLd + ks * 16 + ((lane / 8) % 2) * 8;
        uint32_t kb[4], vb[4];
        ldsm_x4(kb, s_k + b_off);
        ldsm_x4(vb, s_v + b_off);
        mma_16816(s[2 * np], qa, kb[0], kb[1]);
        mma_16816(s[2 * np + 1], qa, kb[2], kb[3]);
        mma_16816(dp[2 * np], da, vb[0], vb[1]);
        mma_16816(dp[2 * np + 1], da, vb[2], vb[3]);
      }
    }

    // P = exp2(S * scale * log2 e - lse * log2 e), exactly 0 for masked and ragged keys;
    // dS = P * (dP - delta), kept in fp32 until it is packed to bf16 for dS K. The same
    // expressions as the fused kernel's.
    const bool ragged = (j + 1) * kBlockN > n_keys;
    const int key0 = j * kBlockN + 2 * t;
#pragma unroll
    for (int nt = 0; nt < kBlockN / 8; ++nt) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const bool keep = !ragged || key0 + nt * 8 + (c % 2) < n_keys;
        const float p = keep ? exp2f(s[nt][c] * scale_log2 - lse_r[c / 2]) : 0.f;
        dp[nt][c] = p * (dp[nt][c] - delta_r[c / 2]);
      }
    }

    // dQ += dS K: dS (bf16) comes straight from the accumulators, K^T by ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < kBlockN / 16; ++kk) {
      const uint32_t a[4] = {
          pack_bf16x2(dp[2 * kk][0], dp[2 * kk][1]), pack_bf16x2(dp[2 * kk][2], dp[2 * kk][3]),
          pack_bf16x2(dp[2 * kk + 1][0], dp[2 * kk + 1][1]),
          pack_bf16x2(dp[2 * kk + 1][2], dp[2 * kk + 1][3])};
#pragma unroll
      for (int d2 = 0; d2 < kHeadDim / 16; ++d2) {
        uint32_t kb[4];
        ldsm_x4_trans(kb, s_k + (kk * 16 + (lane % 8) + ((lane / 8) % 2) * 8) * kSmemLd +
                              d2 * 16 + (lane / 16) * 8);
        mma_16816(acc[2 * d2], a, kb[0], kb[1]);
        mma_16816(acc[2 * d2 + 1], a, kb[2], kb[3]);
      }
    }
    __syncthreads();  // every warp is done with this stage before it is loaded again
  }
  cp_async_wait<0>();

  // Epilogue: dq = acc * scale in bf16, written once; a row with no valid key writes zeros.
#pragma unroll
  for (int dt = 0; dt < kHeadDim / 8; ++dt) {
    const int col = dt * 8 + 2 * t;
    if (ra < sq)
      *reinterpret_cast<uint32_t*>(dq + ra * dq_ss + col) =
          pack_bf16x2(acc[dt][0] * scale, acc[dt][1] * scale);
    if (rb < sq)
      *reinterpret_cast<uint32_t*>(dq + rb * dq_ss + col) =
          pack_bf16x2(acc[dt][2] * scale, acc[dt][3] * scale);
  }
}

// The opt-in to more than 48 KiB of dynamic shared memory, made once per device and kernel
// (`done` is the kernel's own flags), not on every launch; two threads racing here both set
// the same value.
constexpr int kMaxDevices = 64;
bool g_opt_in_fused[kMaxDevices], g_opt_in_dkv[kMaxDevices], g_opt_in_dq[kMaxDevices];

template <typename Kernel>
cudaError_t smem_opt_in(Kernel* kernel, int bytes, bool* done) {
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return err;
  if (device < kMaxDevices && done[device]) return cudaSuccess;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess && device < kMaxDevices) done[device] = true;
  return err;
}

}  // namespace

// Launches the backward kernel on `stream`. q, k, v, dout are [B, S, N, D] views with a unit
// D stride (strides in elements); dk and dv are written through theirs. lse and delta are
// device pointers to [B, N, Sq] fp32 (natural-log LSE; delta = rowsum(dO * O) - dlse).
// kv_len is a device pointer to [B] int32, or null for no key mask. dq_acc is a zeroed
// [B, N, Sq, D] fp32 workspace that receives the unscaled dQ; `dft_flash_bwd_dq_finish`
// turns it into dQ. A null dq_acc runs the split backward's dk/dv pass instead: the same
// kernel without the dQ product, so its dK and dV are bit-equal to the fused kernel's.
// Returns the cudaError_t of the launch (0 on success).
extern "C" int dft_flash_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                                  const void* lse, const void* delta, const void* kv_len,
                                  void* dq_acc, void* dk, void* dv, int batch, int heads, int sq,
                                  int sk, long long q_sb, long long q_ss, long long q_sh,
                                  long long k_sb, long long k_ss, long long k_sh, long long v_sb,
                                  long long v_ss, long long v_sh, long long do_sb,
                                  long long do_ss, long long do_sh, long long dk_sb,
                                  long long dk_ss, long long dk_sh, long long dv_sb,
                                  long long dv_ss, long long dv_sh, float scale, void* stream) {
  const bool with_dq = dq_acc != nullptr;
  const cudaError_t err =
      with_dq ? smem_opt_in(flash_bwd_kernel<true>, kSmemBytes, g_opt_in_fused)
              : smem_opt_in(flash_bwd_kernel<false>, kSmemBytes, g_opt_in_dkv);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sk + kBlockN - 1) / kBlockN, batch * heads);
  auto kernel = with_dq ? flash_bwd_kernel<true> : flash_bwd_kernel<false>;
  kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_len), static_cast<float*>(dq_acc),
      static_cast<__nv_bfloat16*>(dk), static_cast<__nv_bfloat16*>(dv), heads, sq, sk, q_sb,
      q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh, dk_sb, dk_ss, dk_sh,
      dv_sb, dv_ss, dv_sh, scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

// Launches the split backward's dq pass on `stream`: dq = bf16(scale * dS K), accumulated over
// every key tile in registers and written once, with no atomics and no workspace, so it is
// deterministic. q, k, v, dout and dq are [B, S, N, D] views with a unit D stride (strides in
// elements); lse, delta and kv_len as for `dft_flash_bwd_bf16`. Returns the cudaError_t of the
// launch (0 on success).
extern "C" int dft_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                     const void* dout, const void* lse, const void* delta,
                                     const void* kv_len, void* dq, int batch, int heads, int sq,
                                     int sk, long long q_sb, long long q_ss, long long q_sh,
                                     long long k_sb, long long k_ss, long long k_sh,
                                     long long v_sb, long long v_ss, long long v_sh,
                                     long long do_sb, long long do_ss, long long do_sh,
                                     long long dq_sb, long long dq_ss, long long dq_sh,
                                     float scale, void* stream) {
  const cudaError_t err = smem_opt_in(flash_bwd_dq_kernel, kDqSmemBytes, g_opt_in_dq);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((sq + kBlockM - 1) / kBlockM, batch * heads);
  flash_bwd_dq_kernel<<<grid, kDqThreads, kDqSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<const int*>(kv_len), static_cast<__nv_bfloat16*>(dq), heads, sq, sk, q_sb,
      q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, do_sb, do_ss, do_sh, dq_sb, dq_ss, dq_sh,
      scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

// Launches the dQ finishing kernel on `stream`: dq = bf16(dq_acc * scale), dq a [B, Sq, N, D]
// view with a unit D stride and 16-byte aligned rows. Returns the cudaError_t of the launch.
extern "C" int dft_flash_bwd_dq_finish(const void* dq_acc, void* dq, int batch, int heads, int sq,
                                       long long dq_sb, long long dq_ss, long long dq_sh,
                                       float scale, void* stream) {
  const int64_t n_chunks = static_cast<int64_t>(batch) * heads * sq * (kHeadDim / 8);
  const int threads = 256;
  const int64_t blocks = (n_chunks + threads - 1) / threads;
  const int grid = static_cast<int>(blocks < 65536 ? blocks : 65536);
  dq_finish_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(dq_acc), static_cast<__nv_bfloat16*>(dq), heads, sq, n_chunks,
      dq_sb, dq_ss, dq_sh, scale);
  return static_cast<int>(cudaGetLastError());
}
