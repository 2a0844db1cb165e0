// Shared machinery of the port's warp-specialised Hopper (sm_90a) kernels: the flash forward
// (flash_fwd.cu), the flash backward (flash_bwd.cu) and the int8-QK forward (sage_fwd.cu)
// include it.
//
// - the CTA layout all use: two consumer warpgroups running `wgmma` and a producer whose
//   first thread issues TMA loads;
// - mbarrier, TMA and bulk-copy wrappers, named barriers over the consumers, and the two
//   forwards' ping-pong turn barriers;
// - wgmma wrappers and shared-memory descriptors for tiles of [rows, 64] bf16 boxes in the
//   128-byte swizzle (a 128-column row is two boxes), for int8 tiles of [rows, 128] (a
//   128-column row is one box), and the fp32 accumulator to bf16 A fragment conversion;
// - the forwards' P store and P V product (their split calls' combine is in fwd_combine.cuh);
// - on the host, 4-D tensor maps over [B, S, N, 128] bf16 or int8 views and 1-D maps over
//   fp32 vectors, encoded through the driver entry point (no link against libcuda), and the
//   dynamic shared-memory opt-in.
//
// Everything sits in an anonymous namespace: each source that includes it builds into its own
// library.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kHeadDim = 128;
constexpr int kHalf = 64;                  // columns of one 128-byte swizzled box (bf16)
constexpr int kConsumerThreads = 256;      // two consumer warpgroups
constexpr float kLn2 = 0.6931471805599453f;

// bytes of one [rows, 64] bf16 box, and of a [rows, 128] tile (two boxes)
__host__ __device__ constexpr int box_bytes(int rows) { return rows * kHalf * 2; }
__host__ __device__ constexpr int tile_bytes(int rows) { return 2 * box_bytes(rows); }

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

// One box of a 4-D [B, S, N, D] tensor map (coordinates innermost first): [rows, 64] bf16 or
// [rows, 128] int8.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int d0, int h, int row, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(h), "r"(row), "r"(b)
      : "memory");
}

// One box of a 1-D tensor map, starting at element x.
__device__ __forceinline__ void tma_load_1d(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                            int x) {
  asm volatile(
      "cp.async.bulk.tensor.1d.shared::cluster.global.tile.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(x)
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

template <int N>
__device__ __forceinline__ void fence_regs(int (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle. K-major operands: 8-row groups 1024 bytes
// apart (SBO); the K step within a 128-byte row moves the start address by 32 bytes (16 bf16
// or 32 int8 values: the same descriptor serves both types).
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

// D[64 x 128] (+)= A[64 x 16] B[16 x 128], both from shared memory (kTransA, kTransB: 0
// K-major, 1 MN-major), through desc_a and desc_b moved on by kOffA and kOffB bytes inside the
// asm (as DFT_WGMMA_SS_M64N64). With kAccumulate false D = A B, and the outputs are write-only.
#define DFT_WGMMA_SS_M64N128(CONSTRAINT)                                                     \
  asm volatile(                                                                             \
      "{\n.reg .pred p;\n.reg .b64 da, db;\nsetp.ne.b32 p, %66, 0;\n"                        \
      "add.s64 da, %64, %67;\nadd.s64 db, %65, %68;\n"                                        \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "                               \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                              \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                                            \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                                            \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                                            \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                                            \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                                            \
      "%56, %57, %58, %59, %60, %61, %62, %63}, "                                           \
      "da, db, p, 1, 1, %69, %70;\n}\n"                                                     \
      : CONSTRAINT(d[0]), CONSTRAINT(d[1]), CONSTRAINT(d[2]), CONSTRAINT(d[3]),             \
        CONSTRAINT(d[4]), CONSTRAINT(d[5]), CONSTRAINT(d[6]), CONSTRAINT(d[7]),             \
        CONSTRAINT(d[8]), CONSTRAINT(d[9]), CONSTRAINT(d[10]), CONSTRAINT(d[11]),           \
        CONSTRAINT(d[12]), CONSTRAINT(d[13]), CONSTRAINT(d[14]), CONSTRAINT(d[15]),         \
        CONSTRAINT(d[16]), CONSTRAINT(d[17]), CONSTRAINT(d[18]), CONSTRAINT(d[19]),         \
        CONSTRAINT(d[20]), CONSTRAINT(d[21]), CONSTRAINT(d[22]), CONSTRAINT(d[23]),         \
        CONSTRAINT(d[24]), CONSTRAINT(d[25]), CONSTRAINT(d[26]), CONSTRAINT(d[27]),         \
        CONSTRAINT(d[28]), CONSTRAINT(d[29]), CONSTRAINT(d[30]), CONSTRAINT(d[31]),         \
        CONSTRAINT(d[32]), CONSTRAINT(d[33]), CONSTRAINT(d[34]), CONSTRAINT(d[35]),         \
        CONSTRAINT(d[36]), CONSTRAINT(d[37]), CONSTRAINT(d[38]), CONSTRAINT(d[39]),         \
        CONSTRAINT(d[40]), CONSTRAINT(d[41]), CONSTRAINT(d[42]), CONSTRAINT(d[43]),         \
        CONSTRAINT(d[44]), CONSTRAINT(d[45]), CONSTRAINT(d[46]), CONSTRAINT(d[47]),         \
        CONSTRAINT(d[48]), CONSTRAINT(d[49]), CONSTRAINT(d[50]), CONSTRAINT(d[51]),         \
        CONSTRAINT(d[52]), CONSTRAINT(d[53]), CONSTRAINT(d[54]), CONSTRAINT(d[55]),         \
        CONSTRAINT(d[56]), CONSTRAINT(d[57]), CONSTRAINT(d[58]), CONSTRAINT(d[59]),         \
        CONSTRAINT(d[60]), CONSTRAINT(d[61]), CONSTRAINT(d[62]), CONSTRAINT(d[63])          \
      : "l"(desc_a), "l"(desc_b), "r"(kAccumulate ? 1 : 0), "n"(kOffA >> 4), "n"(kOffB >> 4), \
        "n"(kTransA), "n"(kTransB))

template <int kTransA, int kTransB, int kOffA, int kOffB, bool kAccumulate>
__device__ __forceinline__ void wgmma_ss_m64n128(float (&d)[64], uint64_t desc_a,
                                                 uint64_t desc_b) {
  if constexpr (kAccumulate)
    DFT_WGMMA_SS_M64N128(DFT_READ_WRITE);
  else
    DFT_WGMMA_SS_M64N128(DFT_WRITE);
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

// D[64 x 128] = A[64 rows of a K-major [*, 128] tile] B^T[128 rows of another], over D = 128:
// K step kk reads box kk/4 (kABox, kBBox bytes apart) at byte 32 * (kk % 4) of each row.
template <int kABox, int kBBox, int kk = 0>
__device__ __forceinline__ void gemm_kmajor_d128_n128(float (&d)[64], uint64_t a, uint64_t b) {
  wgmma_ss_m64n128<0, 0, (kk / 4) * kABox + (kk % 4) * 32, (kk / 4) * kBBox + (kk % 4) * 32,
                   (kk > 0)>(d, a, b);
  if constexpr (kk + 1 < kHeadDim / 16) gemm_kmajor_d128_n128<kABox, kBBox, kk + 1>(d, a, b);
}

// D[64 x 128] (+)= A[64 x 32] B[32 x 128] in int8 with an s32 accumulator, both operands from
// shared memory and K-major (8-bit wgmma takes no transpose), through desc_a and desc_b moved on
// by kOffA and kOffB bytes inside the asm (as DFT_WGMMA_SS_M64N64). With kAccumulate false
// D = A B, and the outputs are write-only. The accumulator's layout is the fp32 one.
#define DFT_WGMMA_SS_M64N128_S8(CONSTRAINT)                                                  \
  asm volatile(                                                                             \
      "{\n.reg .pred p;\n.reg .b64 da, db;\nsetp.ne.b32 p, %66, 0;\n"                        \
      "add.s64 da, %64, %67;\nadd.s64 db, %65, %68;\n"                                        \
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 "                                   \
      "{%0, %1, %2, %3, %4, %5, %6, %7, "                                                   \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                              \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                                            \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                                            \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                                            \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                                            \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                                            \
      "%56, %57, %58, %59, %60, %61, %62, %63}, "                                           \
      "da, db, p;\n}\n"                                                                     \
      : CONSTRAINT(d[0]), CONSTRAINT(d[1]), CONSTRAINT(d[2]), CONSTRAINT(d[3]),             \
        CONSTRAINT(d[4]), CONSTRAINT(d[5]), CONSTRAINT(d[6]), CONSTRAINT(d[7]),             \
        CONSTRAINT(d[8]), CONSTRAINT(d[9]), CONSTRAINT(d[10]), CONSTRAINT(d[11]),           \
        CONSTRAINT(d[12]), CONSTRAINT(d[13]), CONSTRAINT(d[14]), CONSTRAINT(d[15]),         \
        CONSTRAINT(d[16]), CONSTRAINT(d[17]), CONSTRAINT(d[18]), CONSTRAINT(d[19]),         \
        CONSTRAINT(d[20]), CONSTRAINT(d[21]), CONSTRAINT(d[22]), CONSTRAINT(d[23]),         \
        CONSTRAINT(d[24]), CONSTRAINT(d[25]), CONSTRAINT(d[26]), CONSTRAINT(d[27]),         \
        CONSTRAINT(d[28]), CONSTRAINT(d[29]), CONSTRAINT(d[30]), CONSTRAINT(d[31]),         \
        CONSTRAINT(d[32]), CONSTRAINT(d[33]), CONSTRAINT(d[34]), CONSTRAINT(d[35]),         \
        CONSTRAINT(d[36]), CONSTRAINT(d[37]), CONSTRAINT(d[38]), CONSTRAINT(d[39]),         \
        CONSTRAINT(d[40]), CONSTRAINT(d[41]), CONSTRAINT(d[42]), CONSTRAINT(d[43]),         \
        CONSTRAINT(d[44]), CONSTRAINT(d[45]), CONSTRAINT(d[46]), CONSTRAINT(d[47]),         \
        CONSTRAINT(d[48]), CONSTRAINT(d[49]), CONSTRAINT(d[50]), CONSTRAINT(d[51]),         \
        CONSTRAINT(d[52]), CONSTRAINT(d[53]), CONSTRAINT(d[54]), CONSTRAINT(d[55]),         \
        CONSTRAINT(d[56]), CONSTRAINT(d[57]), CONSTRAINT(d[58]), CONSTRAINT(d[59]),         \
        CONSTRAINT(d[60]), CONSTRAINT(d[61]), CONSTRAINT(d[62]), CONSTRAINT(d[63])          \
      : "l"(desc_a), "l"(desc_b), "r"(kAccumulate ? 1 : 0), "n"(kOffA >> 4), "n"(kOffB >> 4))
#define DFT_READ_WRITE_S32(x) "+r"(x)
#define DFT_WRITE_S32(x) "=r"(x)

template <int kOffA, int kOffB, bool kAccumulate>
__device__ __forceinline__ void wgmma_ss_m64n128_s8(int (&d)[64], uint64_t desc_a,
                                                    uint64_t desc_b) {
  if constexpr (kAccumulate)
    DFT_WGMMA_SS_M64N128_S8(DFT_READ_WRITE_S32);
  else
    DFT_WGMMA_SS_M64N128_S8(DFT_WRITE_S32);
}

// D[64 x 128] = A[64 rows of a K-major int8 [*, 128] tile] B^T[128 rows of another], over
// D = 128: each row is one 128-byte box, and K step kk (32 values) reads byte 32 * kk of it.
template <int kk = 0>
__device__ __forceinline__ void gemm_kmajor_s8_d128_n128(int (&d)[64], uint64_t a, uint64_t b) {
  wgmma_ss_m64n128_s8<kk * 32, kk * 32, (kk > 0)>(d, a, b);
  if constexpr (kk + 1 < kHeadDim / 32) gemm_kmajor_s8_d128_n128<kk + 1>(d, a, b);
}

// --- the forwards' softmax side: turns, exp2, P --------------------------------------------

// Named barriers (0 is __syncthreads, 1 consumer_sync, 2 and 3 warpgroup_sync): kTurnBar + c
// completes when consumer warpgroup c may issue its products (the forwards' ping-pong).
constexpr int kTurnBar = 4;

__device__ __forceinline__ void turn_wait(int c) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(kTurnBar + c), "n"(kConsumerThreads) : "memory");
}

__device__ __forceinline__ void turn_pass(int c) {  // to the other consumer warpgroup
  asm volatile("bar.arrive %0, %1;\n" ::"r"(kTurnBar + 1 - c), "n"(kConsumerThreads)
               : "memory");
}

// exp2 on the MUFU unit alone (no scaling for results below 2^-126: they flush to 0).
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Columns 8j + cq and 8j + cq + 1 of P's rows r0 and r0 + 8 (x[0..1] and x[2..3], this thread's
// in the 64 x 128 fp32 accumulator layout) to shared memory as bf16, K-major in two 64-key
// boxes with the 128-byte swizzle: 16-byte chunk j of row r lands at chunk j ^ (r % 8) of its
// box.
__device__ __forceinline__ void store_p_cols(unsigned char* buf, int r0, int cq, int j,
                                             float x0, float x1, float x2, float x3) {
#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    const int r = r0 + 8 * hi;
    *reinterpret_cast<uint32_t*>(buf + (j / 8) * box_bytes(64) + r * 128 +
                                 (((j % 8) ^ (r % 8)) << 4) + 2 * cq) =
        hi ? pack_bf16x2(x2, x3) : pack_bf16x2(x0, x1);
  }
}

// All of this thread's P (64 values of the accumulator layout), as `store_p_cols`.
__device__ __forceinline__ void store_p(unsigned char* buf, int r0, int cq, const float (&x)[64]) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
    store_p_cols(buf, r0, cq, j, x[4 * j], x[4 * j + 1], x[4 * j + 2], x[4 * j + 3]);
}

// O[64 x 128] += P[64 x 128 keys] V[128 keys x 128]: P K-major (K step kk at box kk / 4, byte
// 32 * (kk % 4) of each row), V MN-major (16 keys, 2,048 bytes, per K step).
template <int kk = 0>
__device__ __forceinline__ void gemm_pv(float (&d)[64], uint64_t p, uint64_t v) {
  wgmma_ss_m64n128<0, 1, (kk / 4) * box_bytes(64) + (kk % 4) * 32, kk * 2048, true>(d, p, v);
  if constexpr (kk + 1 < 128 / 16) gemm_pv<kk + 1>(d, p, v);
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

// A 4-D map over a [B, S, N, 128] view: `geom` holds the dims innermost first (128, N, S, B)
// and the byte strides of dims 1..3; boxes of [rows, cols], 128-byte swizzle (cols * element
// size = 128 bytes: 64 bf16 columns, the default, or 128 int8 ones, whose type is given as
// UINT8), rows past S zero-filled.
bool make_map(CUtensorMap* map, const void* ptr, const unsigned long long* geom, int rows,
              CUtensorMapDataType dtype = CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, int cols = kHalf) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {geom[0], geom[1], geom[2], geom[3]};
  const cuuint64_t strides[3] = {geom[4], geom[5], geom[6]};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(cols), 1, static_cast<cuuint32_t>(rows), 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, dtype, 4, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// A 1-D map over `n` fp32 values (ptr 16-byte aligned), boxes of `box` values (a multiple of
// 4, at most 256), no swizzle; values past n zero-filled.
bool make_map_1d_f32(CUtensorMap* map, const void* ptr, unsigned long long n, int box) {
  EncodeTiled fn = encode_tiled();
  if (fn == nullptr) return false;
  const cuuint64_t dims[1] = {n};
  const cuuint64_t strides[1] = {0};  // a rank-1 map reads none
  const cuuint32_t boxes[1] = {static_cast<cuuint32_t>(box)};
  const cuuint32_t elem[1] = {1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 1, const_cast<void*>(ptr), dims, strides,
            boxes, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
            CU_TENSOR_MAP_L2_PROMOTION_NONE, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The opt-in to more than 48 KiB of dynamic shared memory, made once per device and kernel
// (`done` is the kernel's own flags, kMaxDevices of them), not on every launch; two threads
// racing here both set the same value.
constexpr int kMaxDevices = 64;

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
