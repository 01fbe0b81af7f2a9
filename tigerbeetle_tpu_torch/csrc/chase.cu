// A pointer chase: the card's dependent-load latency, the unit of the
// serial kernels' (K2 serial, K4) latency bounds in chip_smoke.py.
//
// Not a port of a JAX program and not on the ledger's path. One thread
// follows `next` from `start` for `steps` loads, each load's address being
// the previous load's value, so no two loads overlap; the time per step is
// the latency of a load that misses every cache once `next` is a random
// cycle over a buffer larger than L2.
#include <cuda_runtime.h>

#include <cstdint>

__global__ void chase_kernel(const uint32_t* __restrict__ next, uint32_t start, int steps,
                             uint32_t* out) {
  uint32_t i = start;
  for (int s = 0; s < steps; s++) i = __ldcg(next + i);
  *out = i;
}

extern "C" int tb_chase(const uint32_t* next, uint32_t start, int steps, uint32_t* out,
                        cudaStream_t stream) {
  chase_kernel<<<1, 1, 0, stream>>>(next, start, steps, out);
  return (int)cudaGetLastError();
}
