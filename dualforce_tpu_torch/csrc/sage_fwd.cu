// Int8-QK ("sage") attention forward for Hopper (sm_90a): int8 Q and K, bf16 V and output,
// fp32 softmax; and its quantization prologue.
//
// Replaces the Pallas TPU kernel `_sage_fwd_kernel` (dualforce_tpu/ops/flash_attention.py:731),
// launched by `_sage_fwd` (:787) behind `sage_attention` (:857); inference only. Per (batch,
// head) the kernel computes
//     s = float(Qi8 . Ki8^T) * (q_scale[row] * k_scale[key])      (log2 units)
//     P = exp2(s - cap),  o = (P V) / rowsum(P)
// with keys at positions >= kv_len[b] excluded and a row whose sum is 0 (no valid key, or
// every score underflowing) written as exact zeros. The scales arrive as per-row [B, N, Sq]
// and per-key [B, N, Sk] fp32 vectors, expanded from the quantization's block scales, so this
// kernel's tiles are free of the quantization blocks (1232 and 1960 rows at 360p video
// self-attention, multiples of no tile used here). There is no running max: like the TPU
// kernel, sage takes the static shift `cap` only (QK-RMS-normed scores are bounded): kCap, the
// value of FAST_SOFTMAX_CAP in ops/flash_attention.py, fixed at compile time.
//
// The prologue (`_sage_fwd` :800-813, jnp code run by XLA before the Pallas call) is CUDA here
// too, two kernels launched by one call: `k_sum_kernel` sums K over key chunks (of a size the
// caller gives) into a workspace, and `quantize_kernel` gives one CTA to each quantization
// block of Q and of K. A K block's CTA first finishes K's mean over all Sk keys (masked ones
// included) from the chunk sums, in a fixed order: no atomics, so a run repeats itself bit for
// bit. Each CTA reads its block twice, for the absmax (of k - mean for K) and for the codes,
// the second time in reverse row order, so that it starts on the rows the first read left in
// L2. The arithmetic is that of `_sage_fwd` as it runs, under jit, where XLA turns a division
// by a constant into a product with its fp32 reciprocal and folds constant factors: mean =
// sum * (1 / Sk), scale = max(absmax, 1e-8) * (1 / 127), codes = rint(x / scale) (an IEEE
// division, half to even), and a q scale = max(absmax, 1e-8) * q_fold, where q_fold is the
// fp32 product of 1 / 127 and D^-1/2 log2(e).
// Q's codes and scales involve no sum and equal the plain version's bit for bit; K's sum is
// taken in another order than the plain version's, so a K code may differ by one where the
// centred value sits within an ulp of a .5 boundary.
//
// What bounds it on an H100: at the main path's long sequences the kernel is bound by
// tensor-core operations: 2*Sq*Sk*D int8 operations (at 1,979 TOP/s) for Q.K^T plus
// 2*Sq*Sk*D bf16 flops (at 989 TF/s) for P.V, 28.87 ms for 40 heads at 43,120^2 against the
// bf16 forward's 38.50. Beside them each score costs one exp2 on the SM's 16-a-clock MUFU unit,
// about as long as the P.V products: the int32 to fp32 conversion must stay off that unit and
// off the 16-a-clock conversion pipe, so it takes the magic-number route (below).
// Only the short audio-side calls are bound by bytes and launch latency. The prologue is bound
// by bytes: bf16 q and k read, int8 q and k and the fp32 scales written.
//
// Design (the exact forward's, csrc/flash_fwd.cu, on the machinery of hopper.cuh): each CTA
// owns one (batch, head) and 128 query rows and is warp-specialised. A producer warp (its first
// thread) loads Q once, one 128-byte int8 box of 128 rows in the 128-byte swizzle, and streams
// K (one int8 box), its 128 key scales (through a 1-D tensor map, on K's barrier) and V (two
// bf16 boxes) through a ring of three stages of 128 keys (194 KiB of shared memory). Two
// consumer warpgroups own 64 query rows each. Per key tile a consumer computes S = Q K^T with
// int8 `wgmma` m64n128k32 (s32 accumulator, both operands K-major in shared memory: 8-bit
// wgmma takes no transpose), converts S to fp32, scales it and takes exp2(s - cap) on its 64
// registers, storing P as bf16 in the swizzled K-major layout (a 16 KiB buffer per warpgroup)
// column group by column group, releases K and its scales, and adds O += P V with bf16 `wgmma`
// m64n128k16 (V MN-major through the transpose bit); O stays in 64 fp32 registers a thread.
// The consumers take turns on the tensor cores (the forward's ping-pong): each turn issues the
// previous tile's P V and the next tile's S together. P goes through shared memory for the
// forward's reason: ptxas keeps every thread within the launch's 168 registers; it is converted
// and stored column group by column group, so that no array of P is held beside S and O (one
// held spills), and masked only in the tile that holds the last valid key. The softmax is not
// overlapped with the warpgroup's own P V: waiting for S alone with both products in flight
// (`wgmma.wait_group 1`) makes ptxas serialise the products (C7514), a loop with the first and
// last turns peeled to avoid that crashes ptxas (CUDA 12.9), and waiting for S before issuing
// P V gained nothing. Keys past kv_len are masked in the kernel, rows past S are zero-filled by
// TMA, rows past Sq are never written, and work stops at the last key tile that holds a valid
// key. As in the forward, the host splits the key tiles of a call whose CTAs would leave SMs
// idle (the 403-query calls) into ranges and `split_combine_kernel` merges them (every range's
// shift is cap).
//
// S goes from int32 to fp32 by the magic number: |s| <= 127^2 * 128 = 2,064,512 < 2^22, so
// the float with the bits 0x4B400000 + s is 12,582,912 + s exactly, and one integer add and
// one float subtract (on the ALU and FMA pipes) give s. Three stages and this conversion were
// timed against two stages and against I2F, and kept as the fastest (PERF.md, Findings).

#include "hopper.cuh"
#include "fwd_combine.cuh"

namespace {

constexpr int kSageThreads = kConsumerThreads + 32;  // two consumer warpgroups, a producer warp
constexpr int kBlockM = 128;             // query rows per CTA, 64 per consumer warpgroup
constexpr int kBlockN = 128;             // keys per stage
constexpr float kCap = 30.f;  // the static softmax shift, log2 units (FAST_SOFTMAX_CAP)
constexpr int kI8Tile = kBlockN * kHeadDim;  // bytes of an int8 [128, 128] tile: one box
// A key tile's fp32 scales arrive as a box of kScaleBox values from the coordinate rounded down
// to a multiple of 4 (a TMA box starts 16-byte aligned; a head's scales start wherever B * N *
// Sk puts them), into a slot of kScaleSlot bytes (TMA writes to 128-byte aligned addresses).
constexpr int kScaleBox = kBlockN + 4;
constexpr int kScaleSlot = 640;
constexpr int kStages = 3;    // the TMA ring's stages

// shared memory (offsets from a 1024-byte aligned base)
struct SageSmem {
  static constexpr int kQ = 0;
  static constexpr int kKv = kQ + kI8Tile;                  // stage s at + s * kStage: K, V
  static constexpr int kStage = kI8Tile + tile_bytes(kBlockN);
  static constexpr int kP = kKv + kStages * kStage;         // warpgroup c's P at + c * kPBytes
  static constexpr int kPBytes = tile_bytes(64);
  static constexpr int kScales = kP + 2 * kPBytes;          // stage s at + s * kScaleSlot
  static constexpr int kBar = kScales + kStages * kScaleSlot;   // q_full, 4 per stage
  static constexpr int kBytes = kBar + 8 * (1 + 4 * kStages) + 1024;  // + alignment slack
  static_assert(kBytes <= 232448, "fits one SM's shared memory");
};

// The fp32 value of an s32 product s, |s| < 2^22, exactly: the float with the bits
// 0x4B400000 + s is 12,582,912 + s (one integer add and one float subtract).
__device__ __forceinline__ float s32_to_f32(int s) {
  return __int_as_float(s + 0x4B400000) - 12582912.f;
}

// P_i = exp2(float(s) * q_scale * k_scale - cap) for this thread's 64 scores of key tile i,
// added to the row sums and stored to the warpgroup's P buffer as bf16 column group by column
// group: no array of P is held. With kRagged, keys past n_keys give exact zeros. Then K_i and
// its scales are released (empty_k, K_i's empty barrier) and P_i is made visible to the async
// proxy, before the next turn's P V reads it.
template <bool kRagged>
__device__ __forceinline__ void tile_p(int i, const int (&si)[64], unsigned char* smem, int bh,
                                       int sk, int j0, int n_keys, int c, const float (&qs)[2],
                                       int r0, int cq, float (&row_sum)[2], uint32_t empty_k) {
  const int key_start = bh * sk + (j0 + i) * kBlockN;  // the tile's first scale
  const float* ks = reinterpret_cast<const float*>(smem + SageSmem::kScales +
                                                   (i % kStages) * kScaleSlot) +
                    (key_start & 3);
  const int lim = n_keys - (j0 + i) * kBlockN - cq;  // this thread's first masked offset
  unsigned char* p = smem + SageSmem::kP + c * SageSmem::kPBytes;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const float kscale[2] = {ks[8 * j + cq], ks[8 * j + cq + 1]};
    float x[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      x[e] = exp2_approx(fmaf(s32_to_f32(si[4 * j + e]) * qs[e / 2], kscale[e % 2],
                              -kCap));
      if (kRagged && 8 * j + (e % 2) >= lim) x[e] = 0.f;
      row_sum[e / 2] += x[e];
    }
    store_p_cols(p, r0, cq, j, x[0], x[1], x[2], x[3]);
  }
  mbar_arrive(empty_k);
  fence_async_smem();
}

__global__ void __launch_bounds__(kSageThreads, 1)
    sage_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                    const __grid_constant__ CUtensorMap tm_k,
                    const __grid_constant__ CUtensorMap tm_v,
                    const __grid_constant__ CUtensorMap tm_ks, __nv_bfloat16* __restrict__ o,
                    const float* __restrict__ q_scale, const int* __restrict__ kv_len,
                    float* __restrict__ part_o, float* __restrict__ part_ml, int heads, int sq,
                    int sk, int tiles_per_split, int64_t o_sb, int64_t o_ss, int64_t o_sh) {
  using L = SageSmem;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int m0 = blockIdx.x * kBlockM;
  int n_keys = sk;
  if (kv_len != nullptr) n_keys = max(0, min(kv_len[b], sk));
  // this CTA's key tiles: [j0, j0 + n_blocks) of those that hold a valid key
  const int j0 = blockIdx.z * tiles_per_split;
  const int n_blocks = max(0, min(tiles_per_split, (n_keys + kBlockN - 1) / kBlockN - j0));

  const uint32_t q_full = base + L::kBar;
  auto full_k = [&](int s) { return q_full + 8 * (1 + s); };
  auto full_v = [&](int s) { return q_full + 8 * (1 + kStages + s); };
  auto empty_k = [&](int s) { return q_full + 8 * (1 + 2 * kStages + s); };
  auto empty_v = [&](int s) { return q_full + 8 * (1 + 3 * kStages + s); };
  if (tid == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full_k(s), 1);
      mbar_init(full_v(s), 1);
      mbar_init(empty_k(s), kConsumerThreads);
      mbar_init(empty_v(s), kConsumerThreads);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup index, broadcast so that the compiler knows it is warp-uniform: consumer
  // warpgroups 0 and 1, the producer warp 2
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == 2) {
    // Producer: Q once, then per key tile K with its scales, and V, into the ring.
    if (tid == kConsumerThreads && n_blocks > 0) {
      mbar_expect_tx(q_full, kI8Tile);
      tma_load(base + L::kQ, &tm_q, q_full, 0, h, m0, b);
      for (int i = 0; i < n_blocks; ++i) {
        const int s = i % kStages;
        const int row = (j0 + i) * kBlockN;
        const uint32_t k_s = base + L::kKv + s * L::kStage;
        const uint32_t v_s = k_s + kI8Tile;
        const uint32_t parity = ((i / kStages) & 1) ^ 1;
        mbar_wait(empty_k(s), parity);
        mbar_expect_tx(full_k(s), kI8Tile + 4 * kScaleBox);
        tma_load(k_s, &tm_k, full_k(s), 0, h, row, b);
        tma_load_1d(base + L::kScales + s * kScaleSlot, &tm_ks, full_k(s), (bh * sk + row) & ~3);
        mbar_wait(empty_v(s), parity);
        mbar_expect_tx(full_v(s), tile_bytes(kBlockN));
        for (int half = 0; half < 2; ++half)
          tma_load(v_s + half * box_bytes(kBlockN), &tm_v, full_v(s), half * kHalf, h, row, b);
      }
    }
    return;
  }

  // Consumers: warpgroup c owns query rows m0 + 64c .. m0 + 64c + 63.
  const int c = wg;
  const int t = tid % 128;
  const int lane = t % 32;
  const int r0 = 16 * (t / 32) + lane / 4;     // this thread's rows of the warpgroup's: r0, +8
  const int row0 = m0 + 64 * c + r0;
  const int cq = 2 * (lane % 4);               // ... and its first column in each 8
  const uint32_t q_c = base + L::kQ + 64 * c * kHeadDim;   // this warpgroup's 64 int8 rows
  const uint32_t p_c = base + L::kP + c * L::kPBytes;
  float qs[2];  // the q scales of this thread's rows
#pragma unroll
  for (int hi = 0; hi < 2; ++hi)
    qs[hi] = row0 + 8 * hi < sq ? q_scale[static_cast<int64_t>(bh) * sq + row0 + 8 * hi] : 0.f;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float row_sum[2] = {0.f, 0.f};  // this thread's partial sums; reduced over the quad at the end
  int si[64];

  if (n_blocks > 0) {
    mbar_wait(q_full, 0);
    if (c == 1) turn_pass(c);  // warpgroup 0 takes the first turn
    // Turn i issues P_{i-1} V_{i-1} (i > 0) and S_i = Q K_i^T (i < n_blocks), then computes P_i
    // while the other warpgroup's turn is on the tensor cores (the forward's protocol). Each
    // warpgroup takes n_blocks + 1 turns; warpgroup 1 passes none on after its last, so that
    // every arrival on a turn barrier meets a wait.
    for (int i = 0; i <= n_blocks; ++i) {
      const int s = i % kStages;
      const int sp = (i + kStages - 1) % kStages;  // the previous tile's stage
      if (i < n_blocks) mbar_wait(full_k(s), (i / kStages) & 1);
      if (i > 0) mbar_wait(full_v(sp), ((i - 1) / kStages) & 1);
      turn_wait(c);
      wgmma_fence();
      if (i > 0)
        gemm_pv(acc, smem_desc(p_c, 16),
                smem_desc(base + L::kKv + sp * L::kStage + kI8Tile, box_bytes(kBlockN)));
      if (i < n_blocks)
        gemm_kmajor_s8_d128_n128(si, smem_desc(q_c, 16),
                                 smem_desc(base + L::kKv + s * L::kStage, 16));
      wgmma_commit();
      if (c == 0 || i < n_blocks) turn_pass(c);
      wgmma_wait<0>();
      fence_regs(acc);
      if (i > 0) mbar_arrive(empty_v(sp));  // V_{i-1} is read
      if (i == n_blocks) break;
      fence_regs(si);
      // P_i into the buffer (the previous P V, which read it, has completed: this warpgroup
      // waited for it above); keys are masked only in a tile that holds the last valid key
      if ((j0 + i + 1) * kBlockN > n_keys)
        tile_p<true>(i, si, smem, bh, sk, j0, n_keys, c, qs, r0, cq, row_sum, empty_k(s));
      else
        tile_p<false>(i, si, smem, bh, sk, j0, n_keys, c, qs, r0, cq, row_sum, empty_k(s));
      warpgroup_sync(c);
    }
  }

  // Epilogue: a row whose sum is 0 stores zeros.
  float total[2], inv[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    total[r] = row_sum[r];
    total[r] += __shfl_xor_sync(0xffffffffu, total[r], 1);
    total[r] += __shfl_xor_sync(0xffffffffu, total[r], 2);
    inv[r] = 1.f / (total[r] == 0.f ? 1.f : total[r]);
  }
  if (part_o != nullptr) {
    // one key range of a split call: unnormalised O and (cap, l) per row, for the combine
    const int64_t rows = static_cast<int64_t>(gridDim.y) * sq;
    const int64_t first = blockIdx.z * rows + static_cast<int64_t>(bh) * sq;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = row0 + 8 * hi;
      if (row >= sq) continue;
      float* dst = part_o + (first + row) * kHeadDim;
#pragma unroll
      for (int j = 0; j < 16; ++j)
        *reinterpret_cast<float2*>(dst + 8 * j + cq) =
            make_float2(acc[4 * j + 2 * hi], acc[4 * j + 2 * hi + 1]);
      if (lane % 4 == 0)
        *reinterpret_cast<float2*>(part_ml + (first + row) * 2) = make_float2(kCap, total[hi]);
    }
    return;
  }
  o += b * o_sb + h * o_sh;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = row0 + 8 * hi;
    if (row >= sq) continue;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<uint32_t*>(o + row * o_ss + 8 * j + cq) =
          pack_bf16x2(acc[4 * j + 2 * hi] * inv[hi], acc[4 * j + 2 * hi + 1] * inv[hi]);
  }
}

// --- the quantization prologue --------------------------------------------------------------

constexpr int kQuantThreads = 256;
constexpr int kRowGroups = kQuantThreads / 16;  // rows a pass covers: 16 threads x 8 values a row
constexpr int kUnroll = 4;                      // rows each thread keeps in flight

// Eight bf16 values (16 bytes) at p to fp32.
__device__ __forceinline__ void load8(const __nv_bfloat16* p, float (&x)[8]) {
  const uint4 raw = __ldg(reinterpret_cast<const uint4*>(p));
  const __nv_bfloat162* v = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(v[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// partial[chunk][bh][d] = the sum of k[b, key, h, d] over the chunk's sum_chunk keys, summed
// per thread in key order and then over the 16 row groups in order.
__global__ void __launch_bounds__(kQuantThreads)
    k_sum_kernel(const __nv_bfloat16* __restrict__ k, float* __restrict__ partial, int heads,
                 int sk, int sum_chunk, int64_t k_sb, int64_t k_ss, int64_t k_sh) {
  __shared__ float red[kRowGroups][kHeadDim];
  const int bh = blockIdx.y;
  const int sub = threadIdx.x % 16;
  const int group = threadIdx.x / 16;
  const __nv_bfloat16* src = k + (bh / heads) * k_sb + (bh % heads) * k_sh + 8 * sub;
  float sum[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  const int chunk = blockIdx.x;
  const int end = min(sk, (chunk + 1) * sum_chunk);
  for (int row = chunk * sum_chunk + group; row < end; row += kRowGroups) {
    float x[8];
    load8(src + row * k_ss, x);
#pragma unroll
    for (int e = 0; e < 8; ++e) sum[e] += x[e];
  }
#pragma unroll
  for (int e = 0; e < 8; ++e) red[group][8 * sub + e] = sum[e];
  __syncthreads();
  if (threadIdx.x < kHeadDim) {
    float s = 0.f;
#pragma unroll
    for (int g = 0; g < kRowGroups; ++g) s += red[g][threadIdx.x];
    partial[(static_cast<int64_t>(chunk) * gridDim.y + bh) * kHeadDim + threadIdx.x] = s;
  }
}

// One CTA per quantization block: blockIdx.x < n_qblocks takes Q's block blockIdx.x, the rest
// K's. Writes the int8 codes to qi / ki ([B, S, N, 128] contiguous) and the block's scale to
// every row of it in k_scale, or max(absmax, 1e-8) * q_fold in q_scale ([B, N, S] fp32).
__global__ void __launch_bounds__(kQuantThreads)
    quantize_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                    int8_t* __restrict__ qi, int8_t* __restrict__ ki, float* __restrict__ q_scale,
                    float* __restrict__ k_scale, const float* __restrict__ partial, int heads,
                    int sq, int sk, int bq, int bk, int n_qblocks, int n_chunks, int64_t q_sb,
                    int64_t q_ss, int64_t q_sh, int64_t k_sb, int64_t k_ss, int64_t k_sh,
                    float q_fold) {
  __shared__ float s_mean[kHeadDim];
  __shared__ float s_max[kQuantThreads / 32];
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const bool is_k = blockIdx.x >= n_qblocks;
  const int blk = is_k ? blockIdx.x - n_qblocks : blockIdx.x;
  const int len = is_k ? sk : sq;
  const int rows = is_k ? bk : bq;
  const int r0 = blk * rows;
  const int r1 = min(len, r0 + rows);
  const int sub = threadIdx.x % 16;
  const int group = threadIdx.x / 16;
  const int64_t ss = is_k ? k_ss : q_ss;
  const __nv_bfloat16* src =
      (is_k ? k + b * k_sb + h * k_sh : q + b * q_sb + h * q_sh) + 8 * sub;
  int8_t* dst = (is_k ? ki : qi) + (static_cast<int64_t>(b) * len * heads + h) * kHeadDim + 8 * sub;
  const int64_t dst_ss = static_cast<int64_t>(heads) * kHeadDim;

  float mean[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (is_k) {
    if (threadIdx.x < kHeadDim) {
      float s = 0.f;
      for (int ch = 0; ch < n_chunks; ++ch)
        s += partial[(static_cast<int64_t>(ch) * gridDim.y + bh) * kHeadDim + threadIdx.x];
      s_mean[threadIdx.x] = s * (1.f / static_cast<float>(sk));  // XLA's mean under jit
    }
    __syncthreads();
#pragma unroll
    for (int e = 0; e < 8; ++e) mean[e] = s_mean[8 * sub + e];
  }

  // the absmax of the block (of k - mean for K)
  float amax = 0.f;
  for (int row = r0 + group; row < r1; row += kRowGroups * kUnroll) {
    float x[kUnroll][8];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (row + u * kRowGroups < r1) load8(src + (row + u * kRowGroups) * ss, x[u]);
#pragma unroll
    for (int u = 0; u < kUnroll; ++u)
      if (row + u * kRowGroups < r1)
#pragma unroll
        for (int e = 0; e < 8; ++e) amax = fmaxf(amax, fabsf(x[u][e] - mean[e]));
  }
#pragma unroll
  for (int off = 16; off > 0; off /= 2) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  if (threadIdx.x % 32 == 0) s_max[threadIdx.x / 32] = amax;
  __syncthreads();
#pragma unroll
  for (int w = 0; w < kQuantThreads / 32; ++w) amax = fmaxf(amax, s_max[w]);
  amax = fmaxf(amax, 1e-8f);
  const float scale = amax * (1.f / 127.f);  // as XLA folds the / 127

  // the codes, from the last row group back to the first
  const int last = r0 + (r1 - 1 - r0) / kRowGroups * kRowGroups + group;
  for (int row = last < r1 ? last : last - kRowGroups; row >= r0; row -= kRowGroups) {
    float x[8];
    load8(src + row * ss, x);
    uint32_t packed[2] = {0u, 0u};
#pragma unroll
    for (int e = 0; e < 8; ++e) {
      const int code = static_cast<int>(rintf((x[e] - mean[e]) / scale));
      packed[e / 4] |= (static_cast<uint32_t>(code) & 0xFFu) << (8 * (e % 4));
    }
    *reinterpret_cast<uint2*>(dst + row * dst_ss) = make_uint2(packed[0], packed[1]);
  }
  float* scales = (is_k ? k_scale : q_scale) + static_cast<int64_t>(bh) * len;
  const float value = is_k ? scale : amax * q_fold;
  for (int row = r0 + threadIdx.x; row < r1; row += kQuantThreads) scales[row] = value;
}

bool g_opt_in[kMaxDevices];  // per device

}  // namespace

// Launches the sage forward on `stream`. `geom` holds, for q, k (int8) and v (bf16) in that
// order, seven values each: the dims innermost first (128, N, S, B) and the byte strides of N,
// S and B (see `make_map`). o is [B, Sq, N, 128] bf16 written through its strides (in
// elements, a unit D stride). q_scale is [B, N, Sq] and k_scale [B, N, Sk] fp32, contiguous;
// q_scale already holds D^-1/2 * log2(e); B * N * Sk must stay below 2^31. kv_len is a device
// pointer to [B] int32, or null for no key mask. With splits > 1 the key tiles are cut into
// `splits` ranges, each writing its unnormalised O and row state to part_o ([splits, B*N*Sq,
// 128] fp32) and part_ml ([splits, B*N*Sq, 2] fp32), and the combine writes o in the same call.
// Returns the cudaError_t of the first failed launch (0 on success), or -1 if a tensor map
// could not be encoded.
extern "C" int dft_sage_fwd(const void* q, const void* k, const void* v, const void* k_scale,
                            const unsigned long long* geom, void* o, const void* q_scale,
                            const void* kv_len, void* part_o, void* part_ml, int batch,
                            int heads, int sq, int sk, int splits, long long o_sb,
                            long long o_ss, long long o_sh, void* stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_ks;
  if (!make_map(&tm_q, q, geom, kBlockM, CU_TENSOR_MAP_DATA_TYPE_UINT8, kHeadDim) ||
      !make_map(&tm_k, k, geom + 7, kBlockN, CU_TENSOR_MAP_DATA_TYPE_UINT8, kHeadDim) ||
      !make_map(&tm_v, v, geom + 14, kBlockN) ||
      !make_map_1d_f32(&tm_ks, k_scale, static_cast<unsigned long long>(batch) * heads * sk,
                       kScaleBox))
    return kEncodeFailed;
  const bool split = splits > 1;
  float* po = split ? static_cast<float*>(part_o) : nullptr;
  float* pml = split ? static_cast<float*>(part_ml) : nullptr;
  const cudaError_t opt = smem_opt_in(sage_fwd_kernel, SageSmem::kBytes, g_opt_in);
  if (opt != cudaSuccess) return static_cast<int>(opt);
  const int n_tiles = (sk + kBlockN - 1) / kBlockN;
  const int per_split = (n_tiles + splits - 1) / splits;
  const dim3 grid((sq + kBlockM - 1) / kBlockM, batch * heads, splits);
  sage_fwd_kernel<<<grid, kSageThreads, SageSmem::kBytes, static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_k, tm_v, tm_ks, static_cast<__nv_bfloat16*>(o),
      static_cast<const float*>(q_scale), static_cast<const int*>(kv_len), po, pml, heads, sq, sk,
      per_split, o_sb, o_ss, o_sh);
  const int err = static_cast<int>(cudaGetLastError());
  if (err != 0 || !split) return err;
  return launch_split_combine(part_o, part_ml, o, nullptr, batch, heads, sq, splits, o_sb, o_ss,
                              o_sh, stream);
}

// Launches the quantization prologue on `stream`: bf16 q [B, Sq, N, 128] and k [B, Sk, N, 128]
// read through their strides (in elements, a unit D stride, each a multiple of 8, both
// 16-byte aligned) into int8 qi and ki ([B, S, N, 128] contiguous), q_scale [B, N, Sq] (the
// clamped block absmax times q_fold) and k_scale [B, N, Sk], with quantization blocks of bq
// query rows and bk keys. K's mean is summed in chunks of sum_chunk keys (> 0) into `partial`,
// a workspace of ceil(Sk / sum_chunk) * B * N * 128 fp32. Returns the cudaError_t of the first
// failed launch (0 on success).
extern "C" int dft_sage_quantize(const void* q, const void* k, void* qi, void* ki, void* q_scale,
                                 void* k_scale, void* partial, int batch, int heads, int sq,
                                 int sk, int bq, int bk, int sum_chunk, long long q_sb,
                                 long long q_ss, long long q_sh, long long k_sb, long long k_ss,
                                 long long k_sh, float q_fold, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int n_chunks = (sk + sum_chunk - 1) / sum_chunk;
  const int n_qblocks = sq > 0 ? (sq + bq - 1) / bq : 0;
  const int n_kblocks = sk > 0 ? (sk + bk - 1) / bk : 0;
  if (batch * heads == 0 || n_qblocks + n_kblocks == 0) return 0;
  if (n_chunks > 0) {
    k_sum_kernel<<<dim3(n_chunks, batch * heads), kQuantThreads, 0, st>>>(
        static_cast<const __nv_bfloat16*>(k), static_cast<float*>(partial), heads, sk, sum_chunk,
        k_sb, k_ss, k_sh);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  quantize_kernel<<<dim3(n_qblocks + n_kblocks, batch * heads), kQuantThreads, 0, st>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<int8_t*>(qi), static_cast<int8_t*>(ki), static_cast<float*>(q_scale),
      static_cast<float*>(k_scale), static_cast<const float*>(partial), heads, sq, sk, bq, bk,
      n_qblocks, n_chunks, q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, q_fold);
  return static_cast<int>(cudaGetLastError());
}
