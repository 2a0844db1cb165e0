// Flash-attention backward for Hopper (sm_90a): bf16 in and out, fp32 accumulation.
//
// Replaces the Pallas TPU kernels of the backward (dualforce_tpu/ops/flash_attention.py): the
// one-pass `_bwd_fused_kernel` (:365), and the split pair that `_bwd_split` (:569) runs where
// the fused kernel's whole-row dQ scratch would pass its cap (720p, 176,400 tokens):
// `_bwd_dq_kernel` (:284) and `_bwd_dkv_kernel` (:321). From q, k, v, dO, the forward's
// natural-log LSE and delta = rowsum(dO * O) - dlse (`bwd_preprocess_kernel` below, as
// `_bwd_prepare` does) both compute per (batch, head), non-causal, D = 128, with keys at
// positions >= kv_len[b] excluded:
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
// Design (FlashAttention-3's backward for head dim 128): every product is a warpgroup
// `wgmma` (m64nNk16, bf16 in, fp32 accumulators), every tile reaches shared memory by TMA
// with 128-byte swizzle (two 64-column boxes per 128-wide row, the layout the wgmma
// descriptors read), and each CTA is warp-specialised: one producer warpgroup (its first
// thread issues the loads, its registers given up by `setmaxnreg`) and two consumer
// warpgroups, which signal each other through mbarriers.
//
// dk/dv core (`flash_bwd_dkv_kernel`, the fused kernel and the split's dk/dv pass): a CTA owns
// one (batch, head) and 128 keys, 64 per consumer warpgroup. K and V are loaded once; Q, dO
// and the tile's lse and delta stream through a ring of kStages 64-row stages. Per query
// tile each consumer forms S^T = K Q^T and dP^T = V dO^T (both operands in shared memory),
// then P^T and dS^T in registers, converts them to bf16 in the A-fragment layout (the fp32
// accumulator layout maps onto it register for register) and adds dV += P^T dO and
// dK += dS^T Q with A from registers and B = dO, Q read MN-major (the descriptor's
// transpose bit). dK and dV (64 x 128 fp32 each per warpgroup) stay in registers; P never
// leaves them. The fused kernel (kDq) also stores dS^T once in shared memory, computes the
// tile's dQ = dS K (each warpgroup one 64-column half of D, A = dS^T and B = K both
// MN-major), stages its half as fp32 in shared memory and adds it into the fp32 workspace
// with one bulk `cp.reduce.async.bulk ... add.f32`; `dq_finish_kernel` scales the workspace
// and casts it to bf16. The TPU kernel accumulates dQ over the key axis in a whole-row VMEM
// scratch because its grid runs in order; here the key tiles run in parallel on different
// SMs, so the workspace's fp32 summation order, and dQ's last bits, vary from run to run. dK
// and dV are deterministic. The workspace holds each 64-row tile in the order of the
// accumulator registers (`dq_finish_kernel` reads it back), so the staging stores are
// conflict-free and each warpgroup's half is one contiguous 16 KiB range.
//
// Known limit: the dk/dv core holds two 64 x 128 fp32 accumulators a thread beside S^T and
// dP^T, more than the 240 registers a consumer gets; ptxas serialises its wgmmas (C7512) and
// spills a few hundred bytes a thread (phase 2 of chip_smoke.py prints both). The dq pass,
// with one accumulator, does neither.
//
// Split design: the dk/dv pass is the same kernel compiled without the dQ product, its
// staging and the workspace (kDq = false), so its dK and dV are bit-equal to the fused
// kernel's. The dq pass (`flash_bwd_dq_kernel`) gives each CTA one (batch, head) and 128
// query rows, 64 per consumer warpgroup: Q and dO are loaded once, K and V stream through a
// ring of kDqStages 64-key stages; per key tile it forms S = Q K^T and dP = dO V^T, then P and
// dS in registers, and adds dQ += dS K with dS as the register A operand and K read MN-major.
// dQ (64 x 128 fp32 per warpgroup) stays in registers and is written once, so dq is
// deterministic, and the pair holds no fp32 workspace (3.6 GB at 720p video self-attention for
// the fused kernel).
//
// `bwd_preprocess_kernel` computes delta straight from bf16 O and dO in fp32, writes it and
// lse * log2(e) in a [B*N, Sq_pad] layout padded to whole 128-row tiles (rows past Sq: delta 0,
// lse +inf, so their P is exactly 0), which the producers copy with plain bulk copies, and
// zeroes the fused kernel's workspace. Tensors are read as [B, S, N, D] through their strides
// (4-D tensor maps: coordinates within int32, byte strides below 2^40); rows past S are
// zero-filled by TMA; kv_len is masked in the kernels. A key tile that lies wholly past
// kv_len[b] writes zeros and stops; the dq pass stops at the last key tile that holds a valid
// key. The tests hold dq, dk and dv within 2e-2 relative L2 of the fp32 plain version on the
// same bf16 inputs.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 128;
constexpr int kHalf = 64;                  // columns of one 128-byte swizzled box (bf16)
constexpr int kThreads = 384;              // producer warpgroup + two consumer warpgroups
constexpr int kConsumerThreads = 256;
constexpr int kProducerRegs = 24;          // setmaxnreg: 24 * 128 + 240 * 256 = 168 * 384
constexpr int kConsumerRegs = 240;
constexpr float kLog2e = 1.4426950408889634f;

// dk/dv core
constexpr int kKeys = 128;                 // keys per CTA, 64 per consumer warpgroup
constexpr int kRows = 64;                  // query rows per stage
constexpr int kStages = 2;
// dq pass
constexpr int kDqRows = 128;               // query rows per CTA, 64 per consumer warpgroup
constexpr int kDqKeys = 64;                // keys per stage
constexpr int kDqStages = 3;
constexpr int kRowPad = 128;               // lse / delta rows padded to this (both passes)

static_assert(kDqRows == kRowPad && kRowPad % kRows == 0, "padded rows cover whole tiles");

// bytes of one [rows, 64] bf16 box, and of a [rows, 128] tile (two boxes)
__host__ __device__ constexpr int box_bytes(int rows) { return rows * kHalf * 2; }
__host__ __device__ constexpr int tile_bytes(int rows) { return 2 * box_bytes(rows); }

// dk/dv core shared memory (offsets from a 1024-byte aligned base)
constexpr int kOffK = 0;
constexpr int kOffV = kOffK + tile_bytes(kKeys);
constexpr int kOffQ = kOffV + tile_bytes(kKeys);                 // stage s at + s * kStageBytes
constexpr int kStageBytes = 2 * tile_bytes(kRows);               // Q then dO
constexpr int kOffRowStats = kOffQ + kStages * kStageBytes;      // lse[64], delta[64] per stage
constexpr int kOffDs = kOffRowStats + 1024;                      // 2 x dS^T [128 keys, 64 rows]
constexpr int kDsBytes = kKeys * kRows * 2;
constexpr int kOffDqStage = kOffDs + 2 * kDsBytes;               // dQ tile, 64 x 128 fp32
__host__ __device__ constexpr int off_bar_dkv(bool dq) {
  return dq ? kOffDqStage + kRows * kHeadDim * 4 : kOffDs;
}
__host__ __device__ constexpr int smem_dkv(bool dq) {  // + slack for the 1024-byte alignment
  return off_bar_dkv(dq) + 64 + 1024;
}
constexpr uint32_t kStageTx = kStageBytes + 2 * kRows * 4;
constexpr uint32_t kKvTx = 2 * tile_bytes(kKeys);

static_assert(kStages * 2 * kRows * 4 <= 1024, "row statistics fit their slot");

// dq pass shared memory
constexpr int kDqOffQ = 0;
constexpr int kDqOffDo = kDqOffQ + tile_bytes(kDqRows);
constexpr int kDqOffKv = kDqOffDo + tile_bytes(kDqRows);         // stage s: K then V
constexpr int kDqStageBytes = 2 * tile_bytes(kDqKeys);
constexpr int kDqOffBar = kDqOffKv + kDqStages * kDqStageBytes;
constexpr int kSmemDq = kDqOffBar + 64 + 1024;
constexpr uint32_t kDqQTx = 2 * tile_bytes(kDqRows);

static_assert(smem_dkv(true) <= 232448 && kSmemDq <= 232448, "fits one SM's shared memory");

// --- PTX wrappers --------------------------------------------------------------------------

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Waits until the barrier's phase of the given parity has completed. A wait that lasts
// kWaitTrapCycles (seconds, where a stage takes microseconds) traps: a fault in the barrier
// protocol ends the launch with an error instead of holding the card.
constexpr long long kWaitTrapCycles = 1ll << 35;

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > kWaitTrapCycles) __trap();
}

// One [rows, 64] box of a 4-D [B, S, N, D] tensor map (coordinates innermost first).
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int d0, int h, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(h), "r"(row), "r"(b)
      : "memory");
}

// A contiguous copy of `bytes` (a multiple of 16, both ends 16-byte aligned).
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::
          "r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// gmem[i] += smem[i] for `bytes` of fp32, one asynchronous bulk operation.
__device__ __forceinline__ void bulk_reduce_add_f32(float* dst, uint32_t src, uint32_t bytes) {
  asm volatile(
      "cp.reduce.async.bulk.global.shared::cta.bulk_group.add.f32 [%0], [%1], %2;\n" ::"l"(dst),
      "r"(src), "r"(bytes)
      : "memory");
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_wait_all() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Generic-proxy shared-memory writes become visible to the async proxy (wgmma, bulk copies).
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier 1 over the two consumer warpgroups only (0 is __syncthreads).
__device__ __forceinline__ void consumer_sync() {
  asm volatile("bar.sync 1, %0;\n" ::"n"(kConsumerThreads) : "memory");
}

// Barrier 2 + c over consumer warpgroup c alone.
__device__ __forceinline__ void warpgroup_sync(int c) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + c) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of accumulator registers across wgmma waits.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle. K-major operands: 8-row groups 1024 bytes
// apart (SBO); the K step within a 128-byte row moves the start address by 32 bytes.
// MN-major operands: 64-element MN chunks `lbo` bytes apart (LBO), 8-row K groups 1024 bytes
// apart (SBO). The swizzle atoms sit on 1024-byte boundaries, so the base offset is 0.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) | (1ull << 62);
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64], both from shared memory, read through the descriptors
// desc_a and desc_b moved on by kOffA and kOffB bytes. The offsets are added inside the asm, so
// the compiler holds one descriptor per operand and not one per K step (all of them hoisted
// out of the loop would not fit the registers). With kAccumulate false D = A B: the outputs are
// write-only, so the compiler keeps no earlier value of d alive for them.
#define DFT_WGMMA_SS_M64N64(CONSTRAINT)                                                      \
  asm volatile(                                                                             \
      "{\n.reg .pred p;\n.reg .b64 da, db;\nsetp.ne.b32 p, %34, 0;\n"                        \
      "add.s64 da, %32, %37;\nadd.s64 db, %33, %38;\n"                                        \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "                                \
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "              \
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "    \
      "da, db, p, 1, 1, %35, %36;\n}\n"                                                       \
      : CONSTRAINT(d[0]), CONSTRAINT(d[1]), CONSTRAINT(d[2]), CONSTRAINT(d[3]),              \
        CONSTRAINT(d[4]), CONSTRAINT(d[5]), CONSTRAINT(d[6]), CONSTRAINT(d[7]),              \
        CONSTRAINT(d[8]), CONSTRAINT(d[9]), CONSTRAINT(d[10]), CONSTRAINT(d[11]),            \
        CONSTRAINT(d[12]), CONSTRAINT(d[13]), CONSTRAINT(d[14]), CONSTRAINT(d[15]),          \
        CONSTRAINT(d[16]), CONSTRAINT(d[17]), CONSTRAINT(d[18]), CONSTRAINT(d[19]),          \
        CONSTRAINT(d[20]), CONSTRAINT(d[21]), CONSTRAINT(d[22]), CONSTRAINT(d[23]),          \
        CONSTRAINT(d[24]), CONSTRAINT(d[25]), CONSTRAINT(d[26]), CONSTRAINT(d[27]),          \
        CONSTRAINT(d[28]), CONSTRAINT(d[29]), CONSTRAINT(d[30]), CONSTRAINT(d[31])           \
      : "l"(desc_a), "l"(desc_b), "r"(kAccumulate ? 1 : 0), "n"(kTransA), "n"(kTransB),      \
        "n"(kOffA >> 4), "n"(kOffB >> 4))
#define DFT_READ_WRITE(x) "+f"(x)
#define DFT_WRITE(x) "=f"(x)

template <int kTransA, int kTransB, int kOffA, int kOffB, bool kAccumulate>
__device__ __forceinline__ void wgmma_ss_m64n64(float (&d)[32], uint64_t desc_a,
                                                uint64_t desc_b) {
  if constexpr (kAccumulate)
    DFT_WGMMA_SS_M64N64(DFT_READ_WRITE);
  else
    DFT_WGMMA_SS_M64N64(DFT_WRITE);
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], A from registers (bf16 pairs), B from shared memory
// through desc_b moved on by kOffB bytes (added inside the asm, as above).
template <int kTransB, int kOffB>
__device__ __forceinline__ void wgmma_rs_m64n128(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n.reg .b64 db;\nsetp.ne.b32 p, %69, 0;\nadd.s64 db, %68, %71;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, db, p, 1, 1, %70;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d), "n"(kTransB),
        "n"(kOffB >> 4));
}

// Two floats to a bf16 pair; the lower-indexed element goes in the low half.
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragments of a 64 x 64 fp32 accumulator for four K steps of 16: register j*4 + e of
// the accumulator holds row (l/4 + 8*(e/2)), column 8j + 2(l%4) + e%2 of the warp's 16 rows,
// which is the A layout of K step j/2 register for register.
__device__ __forceinline__ void to_a_frags(const float (&x)[32], uint32_t (&a)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    a[kk][0] = pack_bf16x2(x[8 * kk + 0], x[8 * kk + 1]);
    a[kk][1] = pack_bf16x2(x[8 * kk + 2], x[8 * kk + 3]);
    a[kk][2] = pack_bf16x2(x[8 * kk + 4], x[8 * kk + 5]);
    a[kk][3] = pack_bf16x2(x[8 * kk + 6], x[8 * kk + 7]);
  }
}

// A 64 x 64 fp32 accumulator to shared memory as bf16 rows of 64 (128 bytes) in the 128-byte
// swizzle, this thread's rows r0 and r0 + 8 of a 1024-byte aligned buffer: 16-byte chunk j of
// row r lands at chunk j ^ (r % 8).
__device__ __forceinline__ void store_swizzled(unsigned char* buf, int r0, int cq,
                                               const float (&x)[32]) {
#pragma unroll
  for (int j = 0; j < 8; ++j)
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int r = r0 + 8 * hi;
      *reinterpret_cast<uint32_t*>(buf + r * 128 + ((j ^ (r % 8)) << 4) + 2 * cq) =
          pack_bf16x2(x[4 * j + 2 * hi], x[4 * j + 2 * hi + 1]);
    }
}

// D[64 x 64] = A[64 rows of a K-major [*, 128] tile] B^T[64 rows of another], over D = 128:
// K step kk reads box kk/4 (kABox, kBBox bytes apart) at byte 32 * (kk % 4) of each row.
template <int kABox, int kBBox, int kk = 0>
__device__ __forceinline__ void gemm_kmajor_d128(float (&d)[32], uint64_t a, uint64_t b) {
  wgmma_ss_m64n64<0, 0, (kk / 4) * kABox + (kk % 4) * 32, (kk / 4) * kBBox + (kk % 4) * 32,
                  (kk > 0)>(d, a, b);
  if constexpr (kk + 1 < kHeadDim / 16) gemm_kmajor_d128<kABox, kBBox, kk + 1>(d, a, b);
}

// D[64 x 128] += A[64 x 16 kSteps] B[16 kSteps x 128]: A from registers, one K step of 16 per
// a[kk]; B MN-major, 16 of its K rows (2048 bytes) per step.
template <int kSteps, int kk = 0>
__device__ __forceinline__ void gemm_rs_n128(float (&d)[64], const uint32_t (&a)[kSteps][4],
                                             uint64_t b) {
  wgmma_rs_m64n128<1, kk * 2048>(d, a[kk], b, 1);
  if constexpr (kk + 1 < kSteps) gemm_rs_n128<kSteps, kk + 1>(d, a, b);
}

// D[64 x 64] = A B over K = 128 keys, A and B both MN-major, 16 K rows (2048 bytes) per step.
template <int kk = 0>
__device__ __forceinline__ void gemm_mn_k128(float (&d)[32], uint64_t a, uint64_t b) {
  wgmma_ss_m64n64<1, 1, kk * 2048, kk * 2048, (kk > 0)>(d, a, b);
  if constexpr (kk + 1 < kKeys / 16) gemm_mn_k128<kk + 1>(d, a, b);
}

// --- the dk/dv core: the fused kernel (kDq) and the split's dk/dv pass ----------------------
template <bool kDq>
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dkv_kernel(const __grid_constant__ CUtensorMap tm_q,
                         const __grid_constant__ CUtensorMap tm_k,
                         const __grid_constant__ CUtensorMap tm_v,
                         const __grid_constant__ CUtensorMap tm_do,
                         const float* __restrict__ lse_pad, const float* __restrict__ delta_pad,
                         const int* __restrict__ kv_len, float* __restrict__ dq_acc,
                         __nv_bfloat16* __restrict__ dk, __nv_bfloat16* __restrict__ dv,
                         int heads, int sq, int sq_pad, int sk, int64_t dk_sb, int64_t dk_ss,
                         int64_t dk_sh, int64_t dv_sb, int64_t dv_ss, int64_t dv_sh,
                         float scale_log2, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;
  unsigned char* smem = smem_raw + (base - raw);

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int n0 = blockIdx.x * kKeys;
  int n_keys = sk;
  if (kv_len != nullptr) n_keys = max(0, min(kv_len[b], sk));
  dk += b * dk_sb + h * dk_sh;
  dv += b * dv_sb + h * dv_sh;

  if (n0 >= n_keys) {  // every key of the tile is masked: zero dK and dV, nothing else
    const uint32_t zero = 0;
    for (int i = tid; i < kKeys * (kHeadDim / 2); i += kThreads) {
      const int key = n0 + i / (kHeadDim / 2);
      const int col = (i % (kHeadDim / 2)) * 2;
      if (key < sk) {
        *reinterpret_cast<uint32_t*>(dk + key * dk_ss + col) = zero;
        *reinterpret_cast<uint32_t*>(dv + key * dv_ss + col) = zero;
      }
    }
    return;
  }

  const int n_tiles = (sq + kRows - 1) / kRows;  // tiles that hold rows; sq_pad / kRows in all
  const uint32_t bar0 = base + off_bar_dkv(kDq);  // full[kStages], empty[kStages], kv_full
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (kStages + s); };
  const uint32_t kv_full = bar0 + 8 * 2 * kStages;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerThreads);
    }
    mbar_init(kv_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup index, broadcast so that the compiler knows it is warp-uniform and keeps
  // what derives from it (shared-memory addresses, wgmma descriptors) in uniform registers
  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);
  if (wg == 0) {
    // Producer: K and V once, then Q, dO, lse and delta per query tile into the ring.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 0) {
      mbar_expect_tx(kv_full, kKvTx);
      for (int half = 0; half < 2; ++half) {
        tma_load(base + kOffK + half * box_bytes(kKeys), &tm_k, kv_full, half * kHalf, h, n0, b);
        tma_load(base + kOffV + half * box_bytes(kKeys), &tm_v, kv_full, half * kHalf, h, n0, b);
      }
      const float* lse_bh = lse_pad + static_cast<int64_t>(bh) * sq_pad;
      const float* delta_bh = delta_pad + static_cast<int64_t>(bh) * sq_pad;
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % kStages;
        mbar_wait(empty(s), ((i / kStages) & 1) ^ 1);
        mbar_expect_tx(full(s), kStageTx);
        const uint32_t q_s = base + kOffQ + s * kStageBytes;
        const uint32_t do_s = q_s + tile_bytes(kRows);
        for (int half = 0; half < 2; ++half) {
          tma_load(q_s + half * box_bytes(kRows), &tm_q, full(s), half * kHalf, h, i * kRows, b);
          tma_load(do_s + half * box_bytes(kRows), &tm_do, full(s), half * kHalf, h, i * kRows,
                   b);
        }
        const uint32_t stats = base + kOffRowStats + s * 2 * kRows * 4;
        bulk_load(stats, lse_bh + i * kRows, kRows * 4, full(s));
        bulk_load(stats + kRows * 4, delta_bh + i * kRows, kRows * 4, full(s));
      }
    }
    return;
  }

  // Consumers: warpgroup c owns keys n0 + 64c .. n0 + 64c + 63.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int c = wg - 1;
  const int t = tid % 128;
  const int lane = t % 32;
  const int row0 = 16 * (t / 32) + lane / 4;  // this thread's first accumulator row (of 64)
  const int cq = 2 * (lane % 4);              // ... and its first column within each 8
  const bool key_ok[2] = {n0 + 64 * c + row0 < n_keys, n0 + 64 * c + row0 + 8 < n_keys};
  const uint32_t k_c = base + kOffK + 64 * c * 128;  // this warpgroup's 64 rows of box 0
  const uint32_t v_c = base + kOffV + 64 * c * 128;

  float acc_dk[64], acc_dv[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc_dk[i] = acc_dv[i] = 0.f;

  mbar_wait(kv_full, 0);
  for (int i = 0; i < n_tiles; ++i) {
    const int s = i % kStages;
    mbar_wait(full(s), (i / kStages) & 1);
    const uint32_t q_s = base + kOffQ + s * kStageBytes;
    const uint32_t do_s = q_s + tile_bytes(kRows);
    const float* lse_s =
        reinterpret_cast<const float*>(smem + kOffRowStats + s * 2 * kRows * 4);
    const float* delta_s = lse_s + kRows;

    // S^T = K Q^T and dP^T = V dO^T: 64 keys x 64 query rows each.
    float st[32], dpt[32];
    wgmma_fence();
    gemm_kmajor_d128<box_bytes(kKeys), box_bytes(kRows)>(st, smem_desc(k_c, 16),
                                                         smem_desc(q_s, 16));
    wgmma_commit();
    gemm_kmajor_d128<box_bytes(kKeys), box_bytes(kRows)>(dpt, smem_desc(v_c, 16),
                                                         smem_desc(do_s, 16));
    wgmma_commit();

    // P^T = exp2(S^T * scale * log2 e - lse * log2 e), exactly 0 for masked keys (rows here)
    // and for padded query rows (lse +inf); dS^T = P^T * (dP^T - delta).
    wgmma_wait<1>();
    fence_regs(st);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 l2 = *reinterpret_cast<const float2*>(lse_s + 8 * j + cq);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float p = exp2f(st[4 * j + e] * scale_log2 - (e % 2 ? l2.y : l2.x));
        st[4 * j + e] = key_ok[e / 2] ? p : 0.f;
      }
    }
    wgmma_wait<0>();
    fence_regs(dpt);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float2 d2 = *reinterpret_cast<const float2*>(delta_s + 8 * j + cq);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        dpt[4 * j + e] = st[4 * j + e] * (dpt[4 * j + e] - (e % 2 ? d2.y : d2.x));
    }
    uint32_t pa[4][4], dsa[4][4];
    to_a_frags(st, pa);
    to_a_frags(dpt, dsa);
    if constexpr (kDq)  // dS^T to shared memory (buffer i % 2), the dQ product's A
      store_swizzled(smem + kOffDs + (i % 2) * kDsBytes, 64 * c + row0, cq, dpt);

    // dV += P^T dO and dK += dS^T Q: A from registers, B (dO, Q) MN-major over D = 128.
    wgmma_fence();
    gemm_rs_n128(acc_dv, pa, smem_desc(do_s, box_bytes(kRows)));
    gemm_rs_n128(acc_dk, dsa, smem_desc(q_s, box_bytes(kRows)));
    wgmma_commit();

    if constexpr (kDq) {
      // dQ[64 rows, 64c .. 64c + 63] = dS K: A = dS^T (MN-major), B = K's box c (MN-major).
      // The dS^T buffers alternate, so the other warpgroup's next store cannot overwrite a
      // buffer this one still reads: one barrier per tile.
      fence_async_smem();
      consumer_sync();  // both halves of dS^T are in shared memory
      float dq[32];
      wgmma_fence();
      gemm_mn_k128(dq, smem_desc(base + kOffDs + (i % 2) * kDsBytes, box_bytes(kKeys)),
                   smem_desc(base + kOffK + c * box_bytes(kKeys), box_bytes(kKeys)));
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc_dv);
      fence_regs(acc_dk);
      fence_regs(dq);
      mbar_arrive(empty(s));
      // Stage this warpgroup's half of the tile in register order (float4 group j of thread t
      // at (8 c + j) * 128 + t), then its first thread adds the half into the workspace.
      if (t == 0) bulk_wait_read();  // the previous tile's reduce has read the staging
      warpgroup_sync(c);
      float4* stage = reinterpret_cast<float4*>(smem + kOffDqStage);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        stage[(8 * c + j) * 128 + t] =
            make_float4(dq[4 * j], dq[4 * j + 1], dq[4 * j + 2], dq[4 * j + 3]);
      fence_async_smem();
      warpgroup_sync(c);
      if (t == 0) {
        const int64_t tile = static_cast<int64_t>(bh) * (sq_pad / kRows) + i;
        bulk_reduce_add_f32(dq_acc + tile * kRows * kHeadDim + c * (kRows * kHeadDim / 2),
                            base + kOffDqStage + c * (kRows * kHeadDim * 2),
                            kRows * kHeadDim * 2);
      }
    } else {
      wgmma_wait<0>();
      fence_regs(acc_dv);
      fence_regs(acc_dk);
      mbar_arrive(empty(s));
    }
  }
  if constexpr (kDq) {
    if (t == 0) bulk_wait_all();
  }

  // Epilogue: dK (scaled) and dV for this warpgroup's keys; masked keys hold exact zeros.
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + cq;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int key = n0 + 64 * c + row0 + 8 * hi;
      if (key < sk) {
        *reinterpret_cast<uint32_t*>(dk + key * dk_ss + col) =
            pack_bf16x2(acc_dk[4 * j + 2 * hi] * scale, acc_dk[4 * j + 2 * hi + 1] * scale);
        *reinterpret_cast<uint32_t*>(dv + key * dv_ss + col) =
            pack_bf16x2(acc_dv[4 * j + 2 * hi], acc_dv[4 * j + 2 * hi + 1]);
      }
    }
  }
}

// dQ = bf16(workspace * scale). The workspace holds, per (batch * head) and 64-row tile, the
// tile's 64 x 128 fp32 in the order the fused kernel stages it: float4 index
// (8 c + j) * 128 + t holds accumulator registers 4j .. 4j + 3 of thread t of warpgroup c,
// rows 16 (t / 32) + (t % 32) / 4 (+ 8 for the last two), columns 64 c + 8 j + 2 (t % 4) (+ 1).
// One thread per float4; rows past Sq are not written.
__global__ void dq_finish_kernel(const float4* __restrict__ acc, __nv_bfloat16* __restrict__ dq,
                                 int heads, int sq, int n_tiles, int64_t n_vec,
                                 int64_t dq_sb, int64_t dq_ss, int64_t dq_sh, float scale) {
  for (int64_t i = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x; i < n_vec;
       i += static_cast<int64_t>(gridDim.x) * blockDim.x) {
    const int within = static_cast<int>(i % (kRows * kHeadDim / 4));
    const int64_t tile_all = i / (kRows * kHeadDim / 4);
    const int tile = static_cast<int>(tile_all % n_tiles);
    const int64_t bh = tile_all / n_tiles;
    const int b = static_cast<int>(bh / heads);
    const int h = static_cast<int>(bh % heads);
    const int c = within / 1024;
    const int j = (within % 1024) / 128;
    const int t = within % 128;
    const int row = tile * kRows + 16 * (t / 32) + (t % 32) / 4;
    const int col = 64 * c + 8 * j + 2 * (t % 4);
    const float4 x = acc[i];
    __nv_bfloat16* base = dq + b * dq_sb + h * dq_sh + col;
    if (row < sq)
      *reinterpret_cast<uint32_t*>(base + row * dq_ss) = pack_bf16x2(x.x * scale, x.y * scale);
    if (row + 8 < sq)
      *reinterpret_cast<uint32_t*>(base + (row + 8) * dq_ss) =
          pack_bf16x2(x.z * scale, x.w * scale);
  }
}

// --- the split backward's dq pass ----------------------------------------------------------
__global__ void __launch_bounds__(kThreads, 1)
    flash_bwd_dq_kernel(const __grid_constant__ CUtensorMap tm_q,
                        const __grid_constant__ CUtensorMap tm_k,
                        const __grid_constant__ CUtensorMap tm_v,
                        const __grid_constant__ CUtensorMap tm_do,
                        const float* __restrict__ lse_pad, const float* __restrict__ delta_pad,
                        const int* __restrict__ kv_len, __nv_bfloat16* __restrict__ dq,
                        int heads, int sq, int sq_pad, int sk, int64_t dq_sb, int64_t dq_ss,
                        int64_t dq_sh, float scale_log2, float scale) {
  extern __shared__ unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023) & ~1023u;

  const int tid = threadIdx.x;
  const int bh = blockIdx.y;
  const int b = bh / heads;
  const int h = bh % heads;
  const int m0 = blockIdx.x * kDqRows;
  int n_keys = sk;
  if (kv_len != nullptr) n_keys = max(0, min(kv_len[b], sk));
  const int n_blocks = (n_keys + kDqKeys - 1) / kDqKeys;

  const uint32_t bar0 = base + kDqOffBar;  // full[kDqStages], empty[kDqStages], qd_full
  auto full = [&](int s) { return bar0 + 8 * s; };
  auto empty = [&](int s) { return bar0 + 8 * (kDqStages + s); };
  const uint32_t qd_full = bar0 + 8 * 2 * kDqStages;
  if (tid == 0) {
    for (int s = 0; s < kDqStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), kConsumerThreads);
    }
    mbar_init(qd_full, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = __shfl_sync(0xffffffffu, tid / 128, 0);  // warp-uniform, as above
  if (wg == 0) {
    // Producer: Q and dO once, then K and V per key tile into the ring.
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (tid == 0 && n_blocks > 0) {
      mbar_expect_tx(qd_full, kDqQTx);
      for (int half = 0; half < 2; ++half) {
        tma_load(base + kDqOffQ + half * box_bytes(kDqRows), &tm_q, qd_full, half * kHalf, h, m0,
                 b);
        tma_load(base + kDqOffDo + half * box_bytes(kDqRows), &tm_do, qd_full, half * kHalf, h,
                 m0, b);
      }
      for (int j = 0; j < n_blocks; ++j) {
        const int s = j % kDqStages;
        mbar_wait(empty(s), ((j / kDqStages) & 1) ^ 1);
        mbar_expect_tx(full(s), kDqStageBytes);
        const uint32_t k_s = base + kDqOffKv + s * kDqStageBytes;
        const uint32_t v_s = k_s + tile_bytes(kDqKeys);
        for (int half = 0; half < 2; ++half) {
          tma_load(k_s + half * box_bytes(kDqKeys), &tm_k, full(s), half * kHalf, h, j * kDqKeys,
                   b);
          tma_load(v_s + half * box_bytes(kDqKeys), &tm_v, full(s), half * kHalf, h, j * kDqKeys,
                   b);
        }
      }
    }
    return;
  }

  // Consumers: warpgroup c owns query rows m0 + 64c .. m0 + 64c + 63.
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kConsumerRegs));
  const int c = wg - 1;
  const int t = tid % 128;
  const int lane = t % 32;
  const int row0 = m0 + 64 * c + 16 * (t / 32) + lane / 4;  // and row0 + 8
  const int cq = 2 * (lane % 4);
  // lse in log2 units and delta of the thread's two rows; padded rows: +inf and 0
  const float* lse_bh = lse_pad + static_cast<int64_t>(bh) * sq_pad;
  const float* delta_bh = delta_pad + static_cast<int64_t>(bh) * sq_pad;
  const float lse_r[2] = {lse_bh[row0], lse_bh[row0 + 8]};
  const float delta_r[2] = {delta_bh[row0], delta_bh[row0 + 8]};
  const uint32_t q_c = base + kDqOffQ + 64 * c * 128;
  const uint32_t do_c = base + kDqOffDo + 64 * c * 128;

  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;

  if (n_blocks > 0) mbar_wait(qd_full, 0);
  for (int j = 0; j < n_blocks; ++j) {
    const int s = j % kDqStages;
    mbar_wait(full(s), (j / kDqStages) & 1);
    const uint32_t k_s = base + kDqOffKv + s * kDqStageBytes;
    const uint32_t v_s = k_s + tile_bytes(kDqKeys);

    // S = Q K^T and dP = dO V^T: 64 rows x 64 keys each.
    float st[32], dp[32];
    wgmma_fence();
    gemm_kmajor_d128<box_bytes(kDqRows), box_bytes(kDqKeys)>(st, smem_desc(q_c, 16),
                                                              smem_desc(k_s, 16));
    wgmma_commit();
    gemm_kmajor_d128<box_bytes(kDqRows), box_bytes(kDqKeys)>(dp, smem_desc(do_c, 16),
                                                              smem_desc(v_s, 16));
    wgmma_commit();

    // P = exp2(S * scale * log2 e - lse * log2 e), exactly 0 for masked and ragged keys;
    // dS = P * (dP - delta). The same expressions as the dk/dv core's.
    const bool ragged = (j + 1) * kDqKeys > n_keys;
    const int key0 = j * kDqKeys + cq;
    wgmma_wait<1>();
    fence_regs(st);
#pragma unroll
    for (int jj = 0; jj < 8; ++jj)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const bool keep = !ragged || key0 + 8 * jj + (e % 2) < n_keys;
        const float p = exp2f(st[4 * jj + e] * scale_log2 - lse_r[e / 2]);
        st[4 * jj + e] = keep ? p : 0.f;
      }
    wgmma_wait<0>();
    fence_regs(dp);
#pragma unroll
    for (int i = 0; i < 32; ++i) dp[i] = st[i] * (dp[i] - delta_r[(i % 4) / 2]);
    uint32_t dsa[4][4];
    to_a_frags(dp, dsa);

    // dQ += dS K: A from registers, B = K (MN-major over D = 128).
    wgmma_fence();
    gemm_rs_n128(acc, dsa, smem_desc(k_s, box_bytes(kDqKeys)));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
    mbar_arrive(empty(s));
  }

  // Epilogue: dq = acc * scale in bf16, written once; a row with no valid key writes zeros.
  dq += b * dq_sb + h * dq_sh;
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int col = 8 * j + cq;
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      const int row = row0 + 8 * hi;
      if (row < sq)
        *reinterpret_cast<uint32_t*>(dq + row * dq_ss + col) =
            pack_bf16x2(acc[4 * j + 2 * hi] * scale, acc[4 * j + 2 * hi + 1] * scale);
    }
  }
}

// --- the preprocess: delta, lse in log2 units, the zeroed workspace ------------------------
// Two rows per warp, 16 threads per row, 8 columns (16 bytes of O and of dO) per thread.
__global__ void bwd_preprocess_kernel(const __nv_bfloat16* __restrict__ o,
                                      const __nv_bfloat16* __restrict__ dout,
                                      const float* __restrict__ lse,
                                      const float* __restrict__ dlse,
                                      float* __restrict__ delta_pad, float* __restrict__ lse_pad,
                                      float4* __restrict__ ws, int64_t ws_vec, int heads, int sq,
                                      int sq_pad, int64_t rows_pad, int64_t o_sb, int64_t o_ss,
                                      int64_t o_sh, int64_t do_sb, int64_t do_ss,
                                      int64_t do_sh) {
  const int64_t thread = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  const int64_t n_threads = static_cast<int64_t>(gridDim.x) * blockDim.x;
  const int sub = threadIdx.x % 16;
  // rows_pad is even and the stride a multiple of 2, so both halves of a warp run the same
  // trips and the shuffles below see all 32 lanes
  for (int64_t r = thread / 16; r < rows_pad; r += n_threads / 16) {
    const int64_t bh = r / sq_pad;
    const int m = static_cast<int>(r % sq_pad);
    const int b = static_cast<int>(bh / heads);
    const int h = static_cast<int>(bh % heads);
    const bool valid = m < sq;
    float acc = 0.f;
    if (valid) {
      const uint4 ov =
          *reinterpret_cast<const uint4*>(o + b * o_sb + m * o_ss + h * o_sh + 8 * sub);
      const uint4 dv =
          *reinterpret_cast<const uint4*>(dout + b * do_sb + m * do_ss + h * do_sh + 8 * sub);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 of = __bfloat1622float2(o2[i]);
        const float2 df = __bfloat1622float2(d2[i]);
        acc += df.x * of.x;
        acc += df.y * of.y;
      }
    }
#pragma unroll
    for (int off = 8; off > 0; off /= 2) acc += __shfl_xor_sync(0xffffffffu, acc, off);
    if (sub == 0) {
      const int64_t src = bh * sq + m;
      delta_pad[r] = valid ? acc - (dlse != nullptr ? dlse[src] : 0.f) : 0.f;
      lse_pad[r] = valid ? lse[src] * kLog2e : __int_as_float(0x7f800000);
    }
  }
  for (int64_t i = thread; i < ws_vec; i += n_threads) ws[i] = make_float4(0.f, 0.f, 0.f, 0.f);
}

// --- host side -----------------------------------------------------------------------------

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver through the runtime: no link against libcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult status;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &status) == cudaSuccess &&
        status == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 4-D map over a [B, S, N, 128] bf16 view: `geom` holds the dims innermost first (128, N, S,
// B) and the byte strides of dims 1..3; boxes of [rows, 64] columns, 128-byte swizzle, rows
// past S zero-filled.
bool make_map(CUtensorMap* map, const void* ptr, const unsigned long long* geom, int rows) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {geom[0], geom[1], geom[2], geom[3]};
  const cuuint64_t strides[3] = {geom[4], geom[5], geom[6]};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(kHalf), 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
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

constexpr int kEncodeFailed = -1;  // returned when a tensor map cannot be encoded

}  // namespace

// Launches the delta preprocess on `stream`: delta_pad and lse_pad are [B*N, sq_pad] fp32
// (sq_pad a multiple of 128): delta = rowsum(dO * O) - dlse and lse * log2(e) for rows < Sq,
// 0 and +inf past it. o and dout are [B, Sq, N, 128] bf16 views (strides in elements,
// multiples of 8, 16-byte aligned); lse and dlse (dlse may be null) contiguous [B, N, Sq]
// fp32. ws (may be null) receives `ws_floats` zeros (a multiple of 4). Returns the
// cudaError_t of the launch.
extern "C" int dft_flash_bwd_preprocess(const void* o, const void* dout, const void* lse,
                                        const void* dlse, void* delta_pad, void* lse_pad, void* ws,
                                        long long ws_floats, int batch, int heads, int sq,
                                        int sq_pad, long long o_sb, long long o_ss,
                                        long long o_sh, long long do_sb, long long do_ss,
                                        long long do_sh, void* stream) {
  const int64_t rows_pad = static_cast<int64_t>(batch) * heads * sq_pad;
  const int64_t work = rows_pad * 16 > ws_floats / 4 ? rows_pad * 16 : ws_floats / 4;
  const int threads = 256;
  const int64_t blocks = (work + threads - 1) / threads;
  const int grid = static_cast<int>(blocks < 32768 ? blocks : 32768);
  bwd_preprocess_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(o), static_cast<const __nv_bfloat16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(dlse),
      static_cast<float*>(delta_pad), static_cast<float*>(lse_pad), static_cast<float4*>(ws),
      ws_floats / 4, heads, sq, sq_pad, rows_pad, o_sb, o_ss, o_sh, do_sb, do_ss, do_sh);
  return static_cast<int>(cudaGetLastError());
}

// Launches the dk/dv core on `stream`. `geom` holds, for q, k, v and dout in that order, seven
// values each: the dims innermost first (128, N, S, B) and the byte strides of N, S and B (see
// `make_map`). lse_pad and delta_pad come from `dft_flash_bwd_preprocess`. kv_len is a device
// pointer to [B] int32, or null for no key mask. dk and dv are written through their strides
// (in elements). dq_acc is the zeroed workspace of B*N*sq_pad*128 fp32 that receives the
// unscaled dQ in the fused kernel's tile order (`dft_flash_bwd_dq_finish` turns it into dQ);
// a null dq_acc runs the split backward's dk/dv pass instead: the same kernel without the dQ
// product, so its dK and dV are bit-equal to the fused kernel's. Returns the cudaError_t of
// the launch (0 on success), or -1 if a tensor map could not be encoded.
extern "C" int dft_flash_bwd_bf16(const void* q, const void* k, const void* v, const void* dout,
                                  const unsigned long long* geom, const void* lse_pad,
                                  const void* delta_pad, const void* kv_len, void* dq_acc,
                                  void* dk, void* dv, int batch, int heads, int sq, int sq_pad,
                                  int sk,
                                  long long dk_sb, long long dk_ss, long long dk_sh,
                                  long long dv_sb, long long dv_ss, long long dv_sh, float scale,
                                  void* stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (!make_map(&tm_q, q, geom, kRows) || !make_map(&tm_k, k, geom + 7, kKeys) ||
      !make_map(&tm_v, v, geom + 14, kKeys) || !make_map(&tm_do, dout, geom + 21, kRows))
    return kEncodeFailed;
  const bool with_dq = dq_acc != nullptr;
  const dim3 grid((sk + kKeys - 1) / kKeys, batch * heads);
  const cudaError_t err =
      with_dq ? smem_opt_in(flash_bwd_dkv_kernel<true>, smem_dkv(true), g_opt_in_fused)
              : smem_opt_in(flash_bwd_dkv_kernel<false>, smem_dkv(false), g_opt_in_dkv);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kernel = with_dq ? flash_bwd_dkv_kernel<true> : flash_bwd_dkv_kernel<false>;
  kernel<<<grid, kThreads, smem_dkv(with_dq), static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(lse_pad),
      static_cast<const float*>(delta_pad), static_cast<const int*>(kv_len),
      static_cast<float*>(dq_acc), static_cast<__nv_bfloat16*>(dk),
      static_cast<__nv_bfloat16*>(dv), heads, sq, sq_pad, sk, dk_sb, dk_ss, dk_sh, dv_sb, dv_ss,
      dv_sh, scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

// Launches the split backward's dq pass on `stream`: dq = bf16(scale * dS K), accumulated over
// every key tile in registers and written once, with no atomics and no workspace, so it is
// deterministic. geom, lse_pad, delta_pad and kv_len as for `dft_flash_bwd_bf16`; dq is written
// through its strides (in elements). Returns the cudaError_t of the launch (0 on success), or
// -1 if a tensor map could not be encoded.
extern "C" int dft_flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                     const void* dout, const unsigned long long* geom,
                                     const void* lse_pad, const void* delta_pad,
                                     const void* kv_len, void* dq, int batch, int heads, int sq,
                                     int sq_pad, int sk, long long dq_sb, long long dq_ss,
                                     long long dq_sh, float scale, void* stream) {
  CUtensorMap tm_q, tm_k, tm_v, tm_do;
  if (!make_map(&tm_q, q, geom, kDqRows) || !make_map(&tm_k, k, geom + 7, kDqKeys) ||
      !make_map(&tm_v, v, geom + 14, kDqKeys) || !make_map(&tm_do, dout, geom + 21, kDqRows))
    return kEncodeFailed;
  const cudaError_t err = smem_opt_in(flash_bwd_dq_kernel, kSmemDq, g_opt_in_dq);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(sq_pad / kDqRows, batch * heads);
  flash_bwd_dq_kernel<<<grid, kThreads, kSmemDq, static_cast<cudaStream_t>(stream)>>>(
      tm_q, tm_k, tm_v, tm_do, static_cast<const float*>(lse_pad),
      static_cast<const float*>(delta_pad), static_cast<const int*>(kv_len),
      static_cast<__nv_bfloat16*>(dq), heads, sq, sq_pad, sk, dq_sb, dq_ss, dq_sh,
      scale * kLog2e, scale);
  return static_cast<int>(cudaGetLastError());
}

// Launches the dQ finishing kernel on `stream`: dq = bf16(dq_acc * scale) from the fused
// kernel's workspace (B*N*sq_pad*128 fp32 in its tile order), dq a [B, Sq, N, D] view with a
// unit D stride. Returns the cudaError_t of the launch.
extern "C" int dft_flash_bwd_dq_finish(const void* dq_acc, void* dq, int batch, int heads, int sq,
                                       int sq_pad, long long dq_sb, long long dq_ss,
                                       long long dq_sh, float scale, void* stream) {
  const int64_t n_vec = static_cast<int64_t>(batch) * heads * sq_pad * (kHeadDim / 4);
  const int threads = 256;
  const int64_t blocks = (n_vec + threads - 1) / threads;
  const int grid = static_cast<int>(blocks < 65536 ? blocks : 65536);
  dq_finish_kernel<<<grid, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(dq_acc), static_cast<__nv_bfloat16*>(dq), heads, sq,
      sq_pad / kRows, n_vec, dq_sb, dq_ss, dq_sh, scale);
  return static_cast<int>(cudaGetLastError());
}
