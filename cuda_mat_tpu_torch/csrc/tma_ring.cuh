// Hopper (sm_90a) helpers shared by the kernels that stream operands
// through a shared-memory ring (B1, B2 and B5 in const_stencil.cu, B7 in
// stencil2d.cu, B4b in banded_trisolve.cu): a stage of the ring is filled
// by one-dimensional TMA bulk copies (cp.async.bulk) that complete on the
// stage's mbarrier, and every thread waits on that barrier's phase before
// it reads the stage.  Several copies (streams) may share a stage's
// barrier: mbar_expect takes the sum of their bytes.  16-byte vector types for the loads and stores
// of whole 16-byte words, and the _rn arithmetic that keeps the kernels
// bitwise equal to their plain PyTorch twins (nvcc never contracts _rn
// products and sums into an FMA).

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace cmt {

__device__ __forceinline__ float mul_rn(float a, float b) { return __fmul_rn(a, b); }
__device__ __forceinline__ double mul_rn(double a, double b) { return __dmul_rn(a, b); }
__device__ __forceinline__ float add_rn(float a, float b) { return __fadd_rn(a, b); }
__device__ __forceinline__ double add_rn(double a, double b) { return __dadd_rn(a, b); }

// 16 bytes of T
template <typename T> struct Vec16;
template <> struct Vec16<float> { using type = float4; };
template <> struct Vec16<double> { using type = double2; };

template <typename T>
__device__ __forceinline__ typename Vec16<T>::type zero16() {
  typename Vec16<T>::type z;
  T* e = reinterpret_cast<T*>(&z);
  for (int i = 0; i < static_cast<int>(16 / sizeof(T)); ++i) e[i] = T(0);
  return z;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// An mbarrier that one thread arrives on (with the bytes it expects).
__device__ __forceinline__ void mbar_init(std::uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Make the initialised barriers visible to the copy engine.
__device__ __forceinline__ void mbar_fence_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect(std::uint64_t* bar,
                                            unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(std::uint64_t* bar,
                                          unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// Copy `bytes` (a multiple of 16; both addresses 16-byte aligned) from
// device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* smem, const void* gmem,
                                          unsigned bytes,
                                          std::uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1], %2, [%3];\n" ::"r"(smem_addr(smem)),
      "l"(gmem), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

}  // namespace cmt
