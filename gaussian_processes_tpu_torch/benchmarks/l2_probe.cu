// The rate at which the SMs read a buffer that L2 holds (or, larger than
// L2, device memory): plain ld.global.cg loads, and 1-D TMA bulk copies into
// a ring of shared memory as the product kernel's producer issues them.  A
// measurement of the card for benchmarks/gram_backward.py, on no path of
// the port.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Every thread reads float4s grid-strided, `passes` times; the sum keeps
// the loads alive.
__global__ void l2_read_kernel(const float4* __restrict__ buf, size_t n4,
                               int passes, float* out) {
  float acc = 0.f;
  const size_t stride = static_cast<size_t>(gridDim.x) * blockDim.x;
  for (int p = 0; p < passes; ++p) {
#pragma unroll 8
    for (size_t i = static_cast<size_t>(blockIdx.x) * blockDim.x +
                    threadIdx.x;
         i < n4; i += stride) {
      const float4 v = __ldcg(buf + i);
      acc += v.x + v.y + v.z + v.w;
    }
  }
  if (acc == 1234.5f) out[0] = acc;
}

// One thread a block keeps `stages` bulk copies of `chunk` bytes in flight,
// block b copying chunks b, b + blocks, ...
__global__ void l2_bulk_kernel(const uint8_t* __restrict__ buf,
                               size_t nchunks, int chunk, int stages,
                               int passes) {
  extern __shared__ __align__(1024) uint8_t sm[];
  if (threadIdx.x != 0) return;
  const uint32_t base = smem_u32(sm);
  const uint32_t bars = base + stages * chunk;
  for (int s = 0; s < stages; ++s)
    asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bars + 8 * s),
                 "r"(1)
                 : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  auto wait = [&](long long i) {
    const uint32_t bar = bars + 8 * static_cast<uint32_t>(i % stages);
    const uint32_t parity = static_cast<uint32_t>(i / stages) & 1u;
    uint32_t done = 0;
    while (!done)
      asm volatile(
          "{\n\t.reg .pred p;\n\t"
          "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
          "selp.u32 %0, 1, 0, p;\n\t}"
          : "=r"(done)
          : "r"(bar), "r"(parity)
          : "memory");
  };
  long long issued = 0;
  for (int p = 0; p < passes; ++p)
    for (size_t c = blockIdx.x; c < nchunks; c += gridDim.x) {
      const int s = static_cast<int>(issued % stages);
      if (issued >= stages) wait(issued - stages);
      const uint32_t bar = bars + 8 * s;
      asm volatile(
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(bar),
          "r"(chunk)
          : "memory");
      asm volatile(
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
          "[%0], [%1], %2, [%3];" ::"r"(base + s * chunk),
          "l"(buf + c * chunk), "r"(chunk), "r"(bar)
          : "memory");
      ++issued;
    }
  for (long long i = issued > stages ? issued - stages : 0; i < issued; ++i)
    wait(i);
}

}  // namespace

extern "C" int l2_read(const float* buf, size_t bytes, int passes, int blocks,
                       int threads, float* out, void* stream) {
  l2_read_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      reinterpret_cast<const float4*>(buf), bytes / 16, passes, out);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int l2_bulk(const void* buf, size_t bytes, int chunk, int stages,
                       int passes, int blocks, void* stream) {
  const int smem = stages * chunk + 8 * stages;
  cudaError_t e = cudaFuncSetAttribute(
      l2_bulk_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  l2_bulk_kernel<<<blocks, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(buf), bytes / chunk, chunk, stages, passes);
  return static_cast<int>(cudaGetLastError());
}
