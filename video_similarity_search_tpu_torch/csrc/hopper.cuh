// Hopper (sm_90a) building blocks for the port's kernels, as inline PTX:
// mbarriers, TMA tile loads, cp.async, wgmma shared-memory descriptors,
// the m64n128k8 TF32 and m64n64k16 bf16 wgmma, and setmaxnreg. Each
// wrapper is one instruction (or a polling loop around one); the PTX ISA
// is the reference.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ---- mbarrier -------------------------------------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(count)
               : "memory");
}

// makes the initialized barriers visible to the async (TMA) proxy
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// one arrival that also announces `bytes` of TMA traffic to come
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar,
                                                      uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

// spins until the barrier's phase of parity `parity` has completed
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n\t.reg .pred p;\n\t"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
        "selp.u32 %0, 1, 0, p;\n\t}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// ---- TMA ------------------------------------------------------------------

// copies the box at element coordinates (c0 innermost, c1) of `map` into
// shared memory at `dst`; completion is counted in bytes on `bar`
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map,
                                            uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// ---- wgmma ----------------------------------------------------------------

// Descriptor of a K-major operand that TMA wrote with 128-byte swizzle:
// rows of 128 bytes, 8-row groups 1024 bytes apart (SBO), the leading
// offset unused for this layout. The tile must start on 1024 bytes; a
// k-step of 32 bytes inside the swizzle row adds 2 to the descriptor.
__device__ __forceinline__ uint64_t sw128_desc(const void* p) {
  const uint32_t a = smem_u32(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(1) << 16) |
         (static_cast<uint64_t>(1024 >> 4) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads of the accumulator across a wait
template <int N>
__device__ __forceinline__ void fence_acc(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d (64 x 128, fp32, the warpgroup's fragment) = A (64 x 8) . B (128 x 8)^T
// + (scale_d ? d : 0), both operands TF32 in shared memory, K-major. In the
// fragment, thread t of the warpgroup holds rows 16*(t/32) + (t%32)/4 and
// +8, columns 8j + 2*(t%4) + {0,1}: d[4j + 2h + e] is (row + 8h, col + e).
__device__ __forceinline__ void wgmma_m64n128k8_tf32(float (&d)[64],
                                                     uint64_t desc_a,
                                                     uint64_t desc_b,
                                                     int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %66, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, "
      "%43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, "
      "%57, %58, %59, %60, %61, %62, %63}, %64, %65, p, 1, 1;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(scale_d));
}

// Descriptor of a K-major operand with no swizzle: 8-row x 16-byte core
// matrices of 128 contiguous bytes, `lbo` bytes apart along K and `sbo`
// bytes apart along M/N. The start needs only 16-byte alignment.
__device__ __forceinline__ uint64_t interleave_desc(const void* p,
                                                    uint32_t lbo,
                                                    uint32_t sbo) {
  const uint32_t a = smem_u32(p);
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32);
}

// d (64 x 64, fp32) = A (64 x 16) . B (64 x 16)^T + (scale_d ? d : 0), bf16
// operands: A from registers, B K-major in shared memory. A's fragment is
// mma.m16n8k16's, warp w of the warpgroup holding rows 16w..16w+15: thread
// t holds a[0] = (row r, k 2q..2q+1), a[1] = (r + 8, same k), a[2] = (r,
// k 2q+8..2q+9), a[3] = (r + 8, same k), with r = 16w + (t%32)/4, q = t%4,
// the lower k in the low half of each register. d's fragment as above:
// d[4j + 2h + e] is (row r + 8h, column 8j + 2q + e).
__device__ __forceinline__ void wgmma_m64n64k16_bf16_rs(float (&d)[32],
                                                        const uint32_t (&a)[4],
                                                        uint64_t desc_b,
                                                        int scale_d) {
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "setp.ne.b32 p, %37, 0;\n\t"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, "
      "%29, %30, %31}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n\t}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(scale_d));
}

// orders this thread's generic-proxy writes to shared memory before later
// async-proxy reads of it (wgmma operands)
__device__ __forceinline__ void fence_proxy_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// ---- cp.async (per-thread asynchronous copies) ------------------------------

// copies 16 bytes from global to shared memory; with src_bytes 0 it reads
// nothing and writes 16 zero bytes
__device__ __forceinline__ void cp_async_16(void* dst, const void* src,
                                            int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;" ::: "memory");
}

// ---- register rebalancing between warpgroups --------------------------------

template <int R>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(R));
}

template <int R>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(R));
}

}  // namespace hopper
