// Hopper's warpgroup products (wgmma.mma_async, sm_90a) in TF32 with f32
// accumulation, shared by the SSD chunk kernel (ssd_scan.cu), the
// many-row attention kernel (many_row_attention.cuh) and the chunked
// decode's tensor-core route (chunked_decode_tc.cuh): the B operand's
// shared-memory layout and descriptor, the proxy and wgmma fences, the
// m64nNk8 products with A from registers, the register pins an
// asynchronous product needs, and the thread index read where it is used.
//
// A from registers: a 64 x 8 TF32 tile, each warp of the warpgroup its 16
// rows, laid out as mma.m16n8k8's A (lane g = lane / 4, t = lane % 4 holds
// (row g, k t), (row g + 8, k t), (row g, k t + 4), (row g + 8, k t + 4)).
// The accumulator: element 4 c + e of a thread is row g + 8 (e >> 1) of
// its warp's 16, column 8 c + 2 t + (e & 1).
//
// B from shared memory, K-major (TF32 takes no other), without swizzle:
// core matrices of 8 columns x 4 k (16 bytes a column, 128 bytes a core
// matrix), the two core matrices of a column group's 8 k KCORE floats
// apart (the descriptor's leading byte offset), column groups NGROUP
// floats apart (its stride byte offset).  A k-step of an n-column tile is
// n / 8 * NGROUP floats.
#pragma once

#include <stdint.h>

namespace {

constexpr int KCORE = 32;   // 128 bytes
constexpr int NGROUP = 64;  // 256 bytes

// Floats of one 8-deep k-step of an n-column B tile.
__host__ __device__ constexpr int kstep_floats(int n) {
  return n / 8 * NGROUP;
}

// Offset, within a k-step, of the 16-byte core-matrix row of column col
// that holds k indices 4 kc .. 4 kc + 3.
__device__ __forceinline__ int core_offset(int col, int kc) {
  return (col >> 3) * NGROUP + kc * KCORE + (col & 7) * 4;
}

// The SSD chunk's x^T tile (64 columns) and B tile (32 keys, k = ds):
// column col's row of a k-step, and 4-element chunk c4 of key k's row.
constexpr int XT_KSTEP = kstep_floats(64);  // 2 KB
__device__ __forceinline__ int xt_offset(int col) {
  return core_offset(col, 0);
}
constexpr int BT_KSTEP = kstep_floats(32);  // 1 KB
__device__ __forceinline__ int bt_offset(int k, int c4) {
  return (c4 >> 1) * BT_KSTEP + core_offset(k, c4 & 1);
}

__device__ __forceinline__ uint64_t smem_desc(const float* p) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(p));
  return (uint64_t)((a & 0x3FFFF) >> 4) |
         ((uint64_t)(KCORE * 4 >> 4) << 16) |
         ((uint64_t)(NGROUP * 4 >> 4) << 32);
}

// Generic-proxy writes to shared memory, made visible to wgmma's reads.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
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

// d (+)= a . B: the A fragment times the 8 x N B tile at desc, N = 2 x
// the extent of d (32, 64, 80 or 128); acc = 0 overwrites d.
__device__ __forceinline__ void wgmma_tf32(float (&d)[16], const uint32_t* a,
                                           uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[32], const uint32_t* a,
                                           uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

#define WG_D4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])

__device__ __forceinline__ void wgmma_tf32(float (&d)[40], const uint32_t* a,
                                           uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39}, "
      "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : WG_D4(0), WG_D4(4), WG_D4(8), WG_D4(12), WG_D4(16), WG_D4(20),
        WG_D4(24), WG_D4(28), WG_D4(32), WG_D4(36)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

__device__ __forceinline__ void wgmma_tf32(float (&d)[64], const uint32_t* a,
                                           uint64_t desc, int acc) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, "
      "%28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, "
      "%41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, "
      "%54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : WG_D4(0), WG_D4(4), WG_D4(8), WG_D4(12), WG_D4(16), WG_D4(20),
        WG_D4(24), WG_D4(28), WG_D4(32), WG_D4(36), WG_D4(40), WG_D4(44),
        WG_D4(48), WG_D4(52), WG_D4(56), WG_D4(60)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(acc));
}

#undef WG_D4

// The thread's index, read where it is used: the compiler cannot hoist an
// asm volatile out of the key loop, so the copy and staging offsets derived
// from it are recomputed per tile instead of held in registers through the
// products.
__device__ __forceinline__ int thread_index() {
  int t;
  asm volatile("mov.u32 %0, %%tid.x;" : "=r"(t));
  return t;
}

// Pins registers that an asynchronous wgmma reads or writes: the compiler
// may neither reuse them before this point nor read them earlier.
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

}  // namespace
