// Pointer chases: the card's dependent-load latency from device memory and
// from shared memory, the units of the serial kernels' latency bounds in
// chip_smoke.py (K2 serial and K4 walk device memory; K11ts's restated
// bound is one shared-memory round trip an event).
//
// The sector probe (tb_sector_probe) measures the other unit of K8's and
// K10's bounds: the rate at which the card reads chosen 32-byte sectors of
// 128-byte rows, one 16-byte load a sector, a warp's load over 32
// neighbouring rows and each thread's loads issued before any is used (the
// scans' pattern). Sector s is words 8 s .. 8 s + 7; the
// mask 1 (one sector a row, K8 on debit_account_id), 5 (one of each 64-byte
// half: K8 on code) and 3 (two in one half) against 15 (the whole row) says
// whether the card fetches 32 bytes for a sector or more.
//
// The cluster floor (tb_cluster_floor) is the yardstick of the one-cluster
// commits (K2 fast, K11af, K3, K11tf): one launch of one cluster of
// CLUSTER_BLOCKS blocks of CLUSTER_THREADS threads that passes a given
// number of cluster barriers and does nothing else, the least such a kernel
// can take for its phases and claim rounds.
//
// Not a port of a JAX program and not on the ledger's path. One thread
// follows `next` from `start` for `steps` loads, each load's address being
// the previous load's value, so no two loads overlap; the time per step is
// the latency of a load that misses every cache once `next` is a random
// cycle over a buffer larger than L2. The shared-memory chase first copies
// `next` (at most CHASE_SHARED_WORDS words) into the block's shared memory;
// its caller takes the difference of two step counts, which cancels the
// copy and the launch.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "cluster.cuh"

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

#define PROBE_ITEMS 8

template <unsigned MASK>
__global__ void __launch_bounds__(256) sector_probe_kernel(const uint4* __restrict__ rows,
                                                           long long n_rows, uint32_t* out) {
  uint4 v[PROBE_ITEMS][4];
  uint32_t acc = 0u;
  const long long stride = (long long)gridDim.x * blockDim.x * PROBE_ITEMS;
  for (long long r0 = (long long)blockIdx.x * blockDim.x * PROBE_ITEMS + threadIdx.x;
       r0 < n_rows; r0 += stride) {
#pragma unroll
    for (int k = 0; k < PROBE_ITEMS; k++) {  // a warp's load: 32 neighbouring rows
      const long long r = min(r0 + (long long)k * blockDim.x, n_rows - 1);
#pragma unroll
      for (int s = 0; s < 4; s++) {
        if ((MASK >> s) & 1u) v[k][s] = __ldcs(rows + r * 8 + 2 * s);
      }
    }
#pragma unroll
    for (int k = 0; k < PROBE_ITEMS; k++) {
#pragma unroll
      for (int s = 0; s < 4; s++) {
        if ((MASK >> s) & 1u) acc ^= v[k][s].x ^ v[k][s].y ^ v[k][s].z ^ v[k][s].w;
      }
    }
  }
  if (acc == 0x9E3779B9u) *out = acc;  // keeps the loads; almost never stores
}

// rows: n_rows 128-byte rows; mask: the sectors of each row to read (bits
// 0-3: 1, 3, 5 or 15); out: one word, written only by chance.
extern "C" int tb_sector_probe(const uint32_t* rows, long long n_rows, unsigned mask,
                               uint32_t* out, cudaStream_t stream) {
  if (n_rows < 1 || (mask != 1u && mask != 3u && mask != 5u && mask != 15u))
    return (int)cudaErrorInvalidValue;
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  long long blocks = (n_rows + 256 * PROBE_ITEMS - 1) / (256 * PROBE_ITEMS);
  if (blocks > 8ll * sms) blocks = 8ll * sms;
  const uint4* r = reinterpret_cast<const uint4*>(rows);
  if (mask == 1u) sector_probe_kernel<1u><<<(int)blocks, 256, 0, stream>>>(r, n_rows, out);
  if (mask == 3u) sector_probe_kernel<3u><<<(int)blocks, 256, 0, stream>>>(r, n_rows, out);
  if (mask == 5u) sector_probe_kernel<5u><<<(int)blocks, 256, 0, stream>>>(r, n_rows, out);
  if (mask == 15u) sector_probe_kernel<15u><<<(int)blocks, 256, 0, stream>>>(r, n_rows, out);
  return (int)cudaGetLastError();
}

__global__ void __launch_bounds__(CLUSTER_THREADS, 1) cluster_floor_kernel(int barriers) {
  cooperative_groups::cluster_group cluster = cooperative_groups::this_cluster();
  for (int b = 0; b < barriers; b++) cluster.sync();
}

extern "C" int tb_cluster_floor(int barriers, cudaStream_t stream) {
  if (barriers < 0) return (int)cudaErrorInvalidValue;
  static const bool allowed = cudaFuncSetAttribute(cluster_floor_kernel,
                                                   cudaFuncAttributeNonPortableClusterSizeAllowed,
                                                   1) == cudaSuccess;
  (void)allowed;
  launch_cluster(cluster_floor_kernel, barriers, stream);
  return (int)cudaGetLastError();
}
