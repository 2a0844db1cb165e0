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
// kernel's input; serving passes no `lse` and writes nothing more). Scores are scaled by
// D^-1/2 * log2(e) in fp32 before exp2, and P is rounded to bf16 before P V.
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
// bound by bytes and launch latency. Besides the two products, each score costs an exp2 on
// the SM's 16-a-clock MUFU unit: about half of the products' tensor-core time, which the
// design runs beside them.
//
// Design (FlashAttention-3's forward for head dim 128, on the machinery of hopper.cuh): each
// CTA owns one (batch, head) and 128 query rows and is warp-specialised. A producer warp (its
// first thread) loads Q once, as two 64-column boxes in the 128-byte swizzle, and streams K
// and V through a ring of kStages stages of 128 keys by TMA. Each stage has a full and an
// empty barrier for K and the same for V, so that K_j is reloaded once S_j is computed,
// before P_j V_j has read V_j. Two consumer warpgroups own 64 query rows each. Per key tile a
// consumer computes S = Q K^T with `wgmma` m64n128k16 (both operands in shared memory,
// K-major), runs the masked online softmax on the 64 fp32 registers of S, stores P as bf16 in
// the same swizzled K-major layout (a 16 KiB buffer per warpgroup) and adds O += P V with
// `wgmma` (V read MN-major through the descriptor's transpose bit); O stays in 64 fp32
// registers a thread. The two consumers take turns on the tensor cores (ping-pong): each turn
// issues the previous tile's P V and the next tile's S together, and two named barriers pass
// the turn, so that one warpgroup's softmax runs while the other's products are in flight.
// P goes through shared memory, not registers, because ptxas keeps every thread within the
// launch's 168 registers (see kFwdThreads): S and O in flight with P as a register operand
// need ~186, and spill.
// Tensors are read as [B, S, N, D] through 4-D tensor maps over their strides (no transpose
// copy); rows past S are zero-filled by TMA, keys past kv_len are masked in the kernel, and
// rows past Sq are never written. Work stops at the last key tile that holds a valid key, so a
// short kv_len costs only the tiles it needs.
//
// Split over keys: where B * N * ceil(Sq / 128) CTAs would leave SMs idle (the 403-query
// calls), the host splits the key tiles into `splits` ranges (grid z); each CTA then writes
// its unnormalised fp32 O and its row state (shift m, sum l) to a workspace, and
// `split_combine_kernel` (fwd_combine.cuh) merges the ranges: m = max m_i, l = sum l_i 2^(m_i - m),
// o = sum acc_i 2^(m_i - m) / l. In cap mode every m_i is cap.

#include "hopper.cuh"
#include "fwd_combine.cuh"

namespace {

// Two consumer warpgroups and one producer warp. ptxas (CUDA 12.9) allocates every thread
// within the register count the launch leaves it, 168 at one CTA an SM (the 9 warps count as
// 12), and does not raise that for code after `setmaxnreg.inc`: the kernel takes none.
constexpr int kFwdThreads = kConsumerThreads + 32;
constexpr int kBlockM = 128;               // query rows per CTA, 64 per consumer warpgroup
constexpr int kBlockN = 128;               // keys per stage
constexpr int kStages = 2;
constexpr float kMaxFloor = -1.0e4f;       // running-max floor, log2 units (the TPU kernel's)

// shared memory (offsets from a 1024-byte aligned base)
constexpr int kOffQ = 0;
constexpr int kOffKv = kOffQ + tile_bytes(kBlockM);      // stage s at + s * kStageBytes: K, V
constexpr int kStageBytes = 2 * tile_bytes(kBlockN);
constexpr int kOffP = kOffKv + kStages * kStageBytes;    // warpgroup c's P at + c * kPBytes
constexpr int kPBytes = tile_bytes(64);
constexpr int kOffBar = kOffP + 2 * kPBytes;             // q_full, then per stage 4 barriers
constexpr int kSmem = kOffBar + 8 * (1 + 4 * kStages) + 1024;  // + slack for the alignment
constexpr uint32_t kQTx = tile_bytes(kBlockM);
constexpr uint32_t kKvTx = tile_bytes(kBlockN);

static_assert(kSmem <= 232448, "fits one SM's shared memory");

template <bool kCap>
__global__ void __launch_bounds__(kFwdThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                     const __grid_constant__ CUtensorMap tm_k,
                     const __grid_constant__ CUtensorMap tm_v, __nv_bfloat16* __restrict__ o,
                     float* __restrict__ lse, const int* __restrict__ kv_len,
                     float* __restrict__ part_o, float* __restrict__ part_ml, int heads, int sq,
                     int sk, int tiles_per_split, int64_t o_sb, int64_t o_ss, int64_t o_sh,
                     float scale_log2, float cap) {
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

  const uint32_t q_full = base + kOffBar;
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
    // Producer: Q once, then K and V per key tile into the ring.
    if (tid == kConsumerThreads && n_blocks > 0) {
      mbar_expect_tx(q_full, kQTx);
      for (int half = 0; half < 2; ++half)
        tma_load(base + kOffQ + half * box_bytes(kBlockM), &tm_q, q_full, half * kHalf, h, m0, b);
      for (int i = 0; i < n_blocks; ++i) {
        const int s = i % kStages;
        const int row = (j0 + i) * kBlockN;
        const uint32_t k_s = base + kOffKv + s * kStageBytes;
        const uint32_t v_s = k_s + tile_bytes(kBlockN);
        const uint32_t parity = ((i / kStages) & 1) ^ 1;
        mbar_wait(empty_k(s), parity);
        mbar_expect_tx(full_k(s), kKvTx);
        for (int half = 0; half < 2; ++half)
          tma_load(k_s + half * box_bytes(kBlockN), &tm_k, full_k(s), half * kHalf, h, row, b);
        mbar_wait(empty_v(s), parity);
        mbar_expect_tx(full_v(s), kKvTx);
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
  const uint32_t q_c = base + kOffQ + 64 * c * 128;         // this warpgroup's rows of box 0
  const uint32_t p_c = base + kOffP + c * kPBytes;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  float row_max[2] = {-1.0e30f, -1.0e30f};  // log2 units; unused in cap mode
  float row_sum[2] = {0.f, 0.f};  // this thread's partial sums; reduced over the quad at the end

  if (n_blocks > 0) {
    mbar_wait(q_full, 0);
    if (c == 1) turn_pass(c);  // warpgroup 0 takes the first turn
    // Turn i issues P_{i-1} V_{i-1} (i > 0) and S_i = Q K_i^T (i < n_blocks), then runs the
    // softmax of S_i while the other warpgroup's turn is on the tensor cores. Each warpgroup
    // takes n_blocks + 1 turns; warpgroup 1 passes none on after its last, so that every
    // arrival on a turn barrier meets a wait.
    for (int i = 0; i <= n_blocks; ++i) {
      const int s = i % kStages;
      const int sp = (i + kStages - 1) % kStages;  // the previous tile's stage
      if (i < n_blocks) mbar_wait(full_k(s), (i / kStages) & 1);
      if (i > 0) mbar_wait(full_v(sp), ((i - 1) / kStages) & 1);
      float sc[64];
      turn_wait(c);
      wgmma_fence();
      if (i > 0)
        gemm_pv(acc, smem_desc(p_c, 16),
                smem_desc(base + kOffKv + sp * kStageBytes + tile_bytes(kBlockN),
                          box_bytes(kBlockN)));
      if (i < n_blocks)
        gemm_kmajor_d128_n128<box_bytes(kBlockM), box_bytes(kBlockN)>(
            sc, smem_desc(q_c, 16), smem_desc(base + kOffKv + s * kStageBytes, 16));
      wgmma_commit();
      if (c == 0 || i < n_blocks) turn_pass(c);
      wgmma_wait<0>();
      fence_regs(acc);
      if (i > 0) mbar_arrive(empty_v(sp));  // V_{i-1} is read
      if (i == n_blocks) break;
      mbar_arrive(empty_k(s));              // K_i is read
      fence_regs(sc);

      // Online softmax in exp2 units: keys past n_keys (only in the last tile) get -inf.
      const int key0 = (j0 + i) * kBlockN + cq;
      if ((j0 + i + 1) * kBlockN > n_keys) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (key0 + 8 * j + (e % 2) >= n_keys) sc[4 * j + e] = -INFINITY;
      }
      if constexpr (kCap) {
        // static shift: masked keys are -inf and give exact zeros
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            sc[4 * j + e] = exp2_approx(fmaf(sc[4 * j + e], scale_log2, -cap));
            row_sum[e / 2] += sc[4 * j + e];
          }
      } else {
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float mx = -INFINITY;
#pragma unroll
          for (int j = 0; j < 16; ++j) mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * r], sc[4 * j + 2 * r + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          // max(s) * scale is max(s * scale): the scale is positive and rounding monotonic
          const float m_new = fmaxf(fmaxf(row_max[r], mx * scale_log2), kMaxFloor);
          const float alpha = exp2_approx(row_max[r] - m_new);
          row_max[r] = m_new;
          row_sum[r] *= alpha;
#pragma unroll
          for (int j = 0; j < 16; ++j) {
            acc[4 * j + 2 * r] *= alpha;
            acc[4 * j + 2 * r + 1] *= alpha;
          }
#pragma unroll
          for (int j = 0; j < 16; ++j)
#pragma unroll
            for (int e = 2 * r; e < 2 * r + 2; ++e) {
              sc[4 * j + e] = exp2_approx(fmaf(sc[4 * j + e], scale_log2, -m_new));
              row_sum[r] += sc[4 * j + e];
            }
        }
      }
      // P to shared memory, visible to the async proxy before the next turn's P V reads it
      // (the previous P V has completed: this warpgroup waited for it above)
      store_p(smem + kOffP + c * kPBytes, r0, cq, sc);
      fence_async_smem();
      warpgroup_sync(c);
    }
  }

  // Epilogue: a row with no valid key (sum 0) stores zeros; the floor also covers a row that
  // saw no key tile at all.
  float total[2], inv[2], shift[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    total[r] = row_sum[r];
    total[r] += __shfl_xor_sync(0xffffffffu, total[r], 1);
    total[r] += __shfl_xor_sync(0xffffffffu, total[r], 2);
    inv[r] = 1.f / (total[r] == 0.f ? 1.f : total[r]);
    shift[r] = kCap ? cap : fmaxf(row_max[r], kMaxFloor);
  }
  if (part_o != nullptr) {
    // one key range of a split call: unnormalised O and (m, l) per row, for the combine
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
        *reinterpret_cast<float2*>(part_ml + (first + row) * 2) = make_float2(shift[hi], total[hi]);
    }
    return;
  }
  o += b * o_sb + h * o_sh;
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int row = row0 + 8 * hi;
    if (row >= sq) continue;
    if (lse != nullptr && lane % 4 == 0)
      lse[static_cast<int64_t>(bh) * sq + row] =
          (shift[hi] + log2f(total[hi] == 0.f ? 1.f : total[hi])) * kLn2;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      *reinterpret_cast<uint32_t*>(o + row * o_ss + 8 * j + cq) =
          pack_bf16x2(acc[4 * j + 2 * hi] * inv[hi], acc[4 * j + 2 * hi + 1] * inv[hi]);
  }
}

bool g_opt_in[2][kMaxDevices];  // per kernel variant (kCap) and device

}  // namespace

// Launches the forward on `stream`. `geom` holds, for q, k and v in that order, seven values
// each: the dims innermost first (128, N, S, B) and the byte strides of N, S and B (see
// `make_map`). o is written through its strides (in elements, a unit D stride). lse is a device
// pointer to [B, N, Sq] fp32, or null for no LSE output. kv_len is a device pointer to [B]
// int32, or null for no key mask. A nonzero cap_mode runs the cap-mode variant with the static
// shift `cap` (log2 units); cap is unused otherwise. With splits > 1 the key tiles are cut
// into `splits` ranges, and part_o ([splits, B*N*Sq, 128] fp32) and part_ml ([splits, B*N*Sq,
// 2] fp32) receive each range's unnormalised O and row state instead of o and lse:
// `dft_flash_fwd_combine` then writes o and lse. Returns the cudaError_t of the launch (0 on
// success), or -1 if a tensor map could not be encoded.
extern "C" int dft_flash_fwd_bf16(const void* q, const void* k, const void* v,
                                  const unsigned long long* geom, void* o, void* lse,
                                  const void* kv_len, void* part_o, void* part_ml, int batch,
                                  int heads, int sq, int sk, int splits, long long o_sb,
                                  long long o_ss, long long o_sh, float scale_log2, int cap_mode,
                                  float cap, void* stream) {
  CUtensorMap tm_q, tm_k, tm_v;
  if (!make_map(&tm_q, q, geom, kBlockM) || !make_map(&tm_k, k, geom + 7, kBlockN) ||
      !make_map(&tm_v, v, geom + 14, kBlockN))
    return kEncodeFailed;
  auto kernel = cap_mode ? flash_fwd_kernel<true> : flash_fwd_kernel<false>;
  const cudaError_t err = smem_opt_in(kernel, kSmem, g_opt_in[cap_mode ? 1 : 0]);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_tiles = (sk + kBlockN - 1) / kBlockN;
  const int per_split = (n_tiles + splits - 1) / splits;
  const dim3 grid((sq + kBlockM - 1) / kBlockM, batch * heads, splits);
  const bool split = splits > 1;
  kernel<<<grid, kFwdThreads, kSmem, static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), static_cast<float*>(lse),
      static_cast<const int*>(kv_len), split ? static_cast<float*>(part_o) : nullptr,
      split ? static_cast<float*>(part_ml) : nullptr, heads, sq, sk, per_split, o_sb, o_ss, o_sh,
      scale_log2, cap);
  return static_cast<int>(cudaGetLastError());
}

// Launches the combine of a split forward on `stream`: from part_o and part_ml (see
// `dft_flash_fwd_bf16`) it writes o through its strides and, when lse is not null, the LSE.
// Returns the cudaError_t of the launch.
extern "C" int dft_flash_fwd_combine(const void* part_o, const void* part_ml, void* o, void* lse,
                                     int batch, int heads, int sq, int splits, long long o_sb,
                                     long long o_ss, long long o_sh, void* stream) {
  return launch_split_combine(part_o, part_ml, o, lse, batch, heads, sq, splits, o_sb, o_ss, o_sh,
                              stream);
}
