// Pointer chases: the card's dependent-load latency from device memory and
// from shared memory, the units of the serial kernels' latency bounds in
// chip_smoke.py (K2 serial and K4 walk device memory; K11ts's restated
// bound is one shared-memory round trip an event).
//
// Not a port of a JAX program and not on the ledger's path. One thread
// follows `next` from `start` for `steps` loads, each load's address being
// the previous load's value, so no two loads overlap; the time per step is
// the latency of a load that misses every cache once `next` is a random
// cycle over a buffer larger than L2. The shared-memory chase first copies
// `next` (at most CHASE_SHARED_WORDS words) into the block's shared memory;
// its caller takes the difference of two step counts, which cancels the
// copy and the launch.
#include <cuda_runtime.h>

#include <cstdint>

#define CHASE_SHARED_WORDS 8192

__global__ void chase_kernel(const uint32_t* __restrict__ next, uint32_t start, int steps,
                             uint32_t* out) {
  uint32_t i = start;
  for (int s = 0; s < steps; s++) i = __ldcg(next + i);
  *out = i;
}

__global__ void chase_shared_kernel(const uint32_t* __restrict__ next, int words,
                                    uint32_t start, int steps, uint32_t* out) {
  __shared__ uint32_t s_next[CHASE_SHARED_WORDS];
  for (int k = threadIdx.x; k < words; k += blockDim.x) s_next[k] = next[k];
  __syncthreads();
  if (threadIdx.x != 0) return;
  volatile uint32_t* v = s_next;
  uint32_t i = start;
  for (int s = 0; s < steps; s++) i = v[i];
  *out = i;
}

extern "C" int tb_chase(const uint32_t* next, uint32_t start, int steps, uint32_t* out,
                        cudaStream_t stream) {
  chase_kernel<<<1, 1, 0, stream>>>(next, start, steps, out);
  return (int)cudaGetLastError();
}

extern "C" int tb_chase_shared(const uint32_t* next, int words, uint32_t start, int steps,
                               uint32_t* out, cudaStream_t stream) {
  if (words < 1 || words > CHASE_SHARED_WORDS) return (int)cudaErrorInvalidValue;
  chase_shared_kernel<<<1, 256, 0, stream>>>(next, words, start, steps, out);
  return (int)cudaGetLastError();
}
