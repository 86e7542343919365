// Device helpers shared by the kernels of this directory (stencil.cu,
// krylov.cu): the complex zero, mbarriers and bulk asynchronous copies into
// shared memory, and the device switch of a launcher.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace {

template <typename V>
__device__ __forceinline__ V czero() {
  V r;
  r.x = 0;
  r.y = 0;
  return r;
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, unsigned parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
  } while (!done);
}

// One contiguous run of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                          unsigned bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];"
      :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Switches to device `dev` for a launch when it is not the current one, and
// back afterwards.
struct DeviceScope {
  int prev = -1;
  cudaError_t enter(int dev) {
    int cur = 0;
    cudaError_t err = cudaGetDevice(&cur);
    if (err != cudaSuccess || cur == dev) return err;
    err = cudaSetDevice(dev);
    if (err == cudaSuccess) prev = cur;
    return err;
  }
  ~DeviceScope() {
    if (prev >= 0) cudaSetDevice(prev);
  }
};

}  // namespace
