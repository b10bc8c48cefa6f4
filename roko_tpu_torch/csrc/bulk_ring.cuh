// Asynchronous bulk copies from global to shared memory that complete on an
// mbarrier (sm_90), for the ring of time tiles of the staged lingru scans
// (lingru_fwd.cu, lingru_bwd.cu).
//
// A ring slot has one mbarrier, initialised with one arrival. To fill a
// slot, lane 0 of the filling warp arrives on it with the bytes the slot
// will receive (expect_tx), then the warp's lanes start the slot's copies,
// each of which counts its bytes off the barrier when it lands. The phase
// completes when all of them have landed; a consumer waits for the n-th
// filling of a slot with parity n & 1.
//
// Every copy's global source, shared destination and size must be
// multiples of 16 bytes.

#pragma once

#include <cstdint>

namespace bulk {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// One thread initialises each barrier; the whole block then syncs.
__device__ __forceinline__ void init(uint64_t* bar, uint32_t arrivals) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(arrivals) : "memory");
}

// Makes the initialised barriers visible to the copy engine.
__device__ __forceinline__ void init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// Arrive once and expect `bytes` more of copies in the current phase.
__device__ __forceinline__ void arrive_expect(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(bar), "r"(bytes) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// Copy `bytes` from global `src` to shared `dst`, counted off barrier `bar`.
__device__ __forceinline__ void copy(uint32_t dst, const void* src, uint32_t bytes,
                                     uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n"
      :: "r"(dst), "l"(src), "r"(bytes), "r"(bar) : "memory");
}

}  // namespace bulk
