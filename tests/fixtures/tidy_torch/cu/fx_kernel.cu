// Fixture: a CUDA source with a template kernel, a launch and two
// extern "C" entries, for the native-abi check of kernel bindings.
#include <cstdint>
#include <cuda_runtime.h>

template <typename T>
__global__ void scale(T* out, const T* in, long long n) {
  long long i = blockIdx.x * (long long)blockDim.x + threadIdx.x;
  if (i < n) out[i] = in[i] * 2;
}

extern "C" long long tb_fx_scratch(long long n) { return 4 * n; }

extern "C" int tb_fx_scale(void* out, const void* in, long long n,
                           void* stream) {
  scale<uint32_t><<<(unsigned)((n + 255) / 256), 256, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<uint32_t*>(out), static_cast<const uint32_t*>(in), n);
  return (int)cudaGetLastError();
}
