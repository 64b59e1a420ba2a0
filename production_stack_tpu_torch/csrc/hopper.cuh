// Hopper (sm_90a) primitives the attention kernels share: 16- and 4-byte
// asynchronous copies into shared memory (cp.async), plain 16-byte
// shared stores, mbarriers, tensor
// copies by the TMA, named barriers and register-budget controls, the
// 128-byte swizzled shared-memory layout that wgmma reads, its matrix
// descriptor, the bf16 wgmma forms the prefill and flash kernels issue,
// and the warp-level mma.sync form the decode kernel issues.
//
// Include inside an anonymous namespace's translation unit only: every
// definition here is internal to the including source.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared, asynchronous; `valid` false zero-fills the
// destination and reads nothing (src must still be a mapped address)
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared, asynchronous (through L1); `valid` false
// zero-fills as cp_async16 does
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

// bring the line holding `p` (global memory) into L1, not waiting for it
__device__ __forceinline__ void prefetch_l1(const void* p) {
  asm volatile("prefetch.global.L1 [%0];\n" ::"l"(p));
}

// 16 bytes into shared memory by a plain store (generic proxy: fence it
// with fence_proxy_async before wgmma reads it)
__device__ __forceinline__ void st_shared16(uint32_t dst, uint4 v) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(dst),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// wait until every cp.async of this thread has landed, committed to a
// group or not
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// wait until at most N committed groups of this thread are in flight
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// mbarriers in shared memory (8 bytes each): a phase completes when
// `count` arrivals have been made; waits name the parity of the phase
// they wait to complete (0 first, then 1, 0, ...)
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}
// make the initialised barriers visible before any thread uses them
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}
// one arrival on `bar` once every cp.async this thread issued so far
// has landed (the arrival counts toward the barrier's count)
__device__ __forceinline__ void cp_async_mbar_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}
// make `bar`'s current phase wait, without an arrival of its own, for
// every cp.async this thread issued so far (the pending count rises now
// and falls when they land): call it before this thread's arrival
__device__ __forceinline__ void cp_async_mbar_track(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.shared::cta.b64 [%0];\n" ::"r"(bar)
               : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  asm volatile(
      "{\n.reg .pred done;\n"
      "WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      "@done bra DONE;\n"
      "bra WAIT;\n"
      "DONE:\n}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// one arrival on `bar` that also raises the bytes the current phase
// waits for by `bytes` (the TMA copies that complete it count them down)
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both
// 16-byte aligned, by the bulk copy engine; they complete_tx on `bar`
__device__ __forceinline__ void bulk_copy_g2s(uint32_t dst, const void* src,
                                              uint32_t bytes, uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(dst),
      "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

// TMA: the box of a 4-D tensor map at coordinates (c0, c1, c2, c3),
// innermost first, into shared memory at `dst`; its bytes complete_tx on
// `bar`. Elements outside the tensor arrive as zeros. `map` is the
// address of a __grid_constant__ CUtensorMap kernel parameter.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// named barrier `id` (1..15; 0 is __syncthreads) of `threads` threads:
// sync waits for them all, arrive counts this thread and goes on
__device__ __forceinline__ void named_barrier_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_barrier_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// a warpgroup's per-thread register budget, lowered (a producer) or
// raised (a consumer) from the launch's; all its 128 threads execute it
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// make shared-memory writes of the generic proxy (cp.async, st.shared)
// visible to the async proxy that wgmma reads through
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Byte offset of 16-byte chunk `chunk` of row `row` in a [64, W] bf16 tile
// stored for wgmma with the 128-byte swizzle: W/64 column blocks of
// [64 rows, 64 values] one after another (8 KB each), each row 128 bytes,
// its 16-byte chunk index XORed with row % 8 (Swizzle<3,4,3>). The tile
// base must be 1024-byte aligned.
__device__ __forceinline__ uint32_t sw128(int row, int chunk) {
  return (chunk >> 3) * 8192 + row * 128 + (((chunk & 7) ^ (row & 7)) << 4);
}

// Shared-memory matrix descriptor (PTX ISA, "Matrix Descriptor Format"):
// start address, leading and stride byte offsets in 16-byte units, layout
// 128-byte swizzle. K-major operand: sbo = 1024 (8 rows of 128 bytes),
// lbo unused. MN-major operand: sbo = 1024 (8 K-rows), lbo = the stride
// between 64-wide MN blocks.
__device__ __forceinline__ uint64_t wgmma_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) |
         ((uint64_t)((lbo & 0x3FFFF) >> 4) << 16) |
         ((uint64_t)((sbo & 0x3FFFF) >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// wait until at most N committed wgmma groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Tie registers that an asynchronous wgmma writes (or reads) to this
// point of the program, so the compiler moves no access across it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

#define PSTPU_D32(d)                                                       \
  "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), \
      "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),        \
      "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),    \
      "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),    \
      "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),    \
      "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),    \
      "+f"(d[31])
#define PSTPU_D32_SLOTS                                                    \
  "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "  \
  "%30, %31}"

// d[64 x 64] (+)= A[64 x 16] . B[16 x 64], bf16 in, f32 accumulate; A and
// B from shared memory, both K-major. scale_d 0 overwrites d.
// Accumulator layout: warp w of the warpgroup holds rows 16w..16w+15;
// thread lane holds d[i] at row 16w + lane/4 + 8*((i/2)%2), column
// 8*(i/4) + 2*(lane%4) + i%2.
__device__ __forceinline__ void wgmma_m64n64k16_ss(float (&d)[32],
                                                   uint64_t a, uint64_t b,
                                                   int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PSTPU_D32_SLOTS
      ", %32, %33, p, 1, 1, 0, 0;\n}\n"
      : PSTPU_D32(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

// d[64 x 64] += A[64 x 16] . B[16 x 64]; A from registers (four bf16x2 a
// thread, the m16n8k16 A-fragment layout per warp), B from shared memory
// MN-major (transposed).
__device__ __forceinline__ void wgmma_m64n64k16_rs_tb(float (&d)[32],
                                                      const uint32_t (&a)[4],
                                                      uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 " PSTPU_D32_SLOTS
      ", {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : PSTPU_D32(d)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#define PSTPU_D64(d)  \
    "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), \
    "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), \
    "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), \
    "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), \
    "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), \
    "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), \
    "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), \
    "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), \
    "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), \
    "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), \
    "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), \
    "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), \
    "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
#define PSTPU_D64_SLOTS \
    "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, " \
    "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, " \
    "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, " \
    "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, " \
    "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}"

// d[64 x 128] (+)= A[64 x 16] . B[16 x 128], bf16 in, f32 accumulate;
// A and B from shared memory, both K-major; the accumulator layout of
// the m64n64k16 form, continued along N (d[i] at column 8*(i/4) + ...).
__device__ __forceinline__ void wgmma_m64n128k16_ss(float (&d)[64],
                                                    uint64_t a, uint64_t b,
                                                    int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 " PSTPU_D64_SLOTS
      ", %64, %65, p, 1, 1, 0, 0;\n}\n"
      : PSTPU_D64(d)
      : "l"(a), "l"(b), "r"(scale_d));
}

#undef PSTPU_D32
#undef PSTPU_D32_SLOTS
#undef PSTPU_D64
#undef PSTPU_D64_SLOTS

// d[16 x 8] += A[16 x 16] . B[16 x 8], bf16 in, f32 accumulate, one warp
// (mma.sync m16n8k16; the PTX ISA's fragment layouts). With g = lane / 4
// and c = lane % 4: a[0] holds A[g][2c, 2c+1], a[1] A[g+8][2c, 2c+1],
// a[2] A[g][2c+8, 2c+9], a[3] A[g+8][2c+8, 2c+9]; b0 holds B[2c, 2c+1][g],
// b1 B[2c+8, 2c+9][g]; d[0..1] is D[g][2c, 2c+1], d[2..3] D[g+8][2c, 2c+1]
// (the lower half of a bf16x2 register is the first element).
__device__ __forceinline__ void mma_m16n8k16(float (&d)[4],
                                             const uint32_t (&a)[4],
                                             uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// byte k (0..3) of w, an int8, as f32, without I2F (a quarter-rate
// instruction): the byte with its sign bit flipped (b + 128 as unsigned)
// becomes the low mantissa byte of 2^23 by a byte permute, and
// subtracting 2^23 + 128 is exact
__device__ __forceinline__ float int8_byte_to_f32(uint32_t w, int k) {
  return __uint_as_float(__byte_perm(w ^ 0x80808080u, 0x4B000000u,
                                     0x7650 + k)) -
         8388736.f;
}

// what rounding (lo, hi) to the bf16x2 `rounded` left, as a bf16x2
__device__ __forceinline__ uint32_t bf16x2_residual(uint32_t rounded,
                                                    float lo, float hi) {
  return pack_bf16x2(lo - __uint_as_float(rounded << 16),
                     hi - __uint_as_float(rounded & 0xffff0000u));
}

// bytes k0 of w0 and k1 of w1, int8 values, as one bf16x2 (exact; w0's
// in the lower half)
__device__ __forceinline__ uint32_t int8_pair_to_bf16x2(uint32_t w0, int k0,
                                                        uint32_t w1, int k1) {
  return pack_bf16x2(int8_byte_to_f32(w0, k0), int8_byte_to_f32(w1, k1));
}

// 16 int8 values as 16 bf16 (exact: |v| <= 127 needs 7 bits), in order:
// values 0..7 to `lo`, 8..15 to `hi`
__device__ __forceinline__ void int8x16_to_bf16(uint4 in, uint4& lo,
                                                uint4& hi) {
  const uint32_t w[4] = {in.x, in.y, in.z, in.w};
  uint32_t o[8];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = pack_bf16x2(int8_byte_to_f32(w[i], 0),
                           int8_byte_to_f32(w[i], 1));
    o[2 * i + 1] = pack_bf16x2(int8_byte_to_f32(w[i], 2),
                               int8_byte_to_f32(w[i], 3));
  }
  lo = make_uint4(o[0], o[1], o[2], o[3]);
  hi = make_uint4(o[4], o[5], o[6], o[7]);
}

}  // namespace
