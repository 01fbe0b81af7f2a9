// K9: snapshot row install: a table's 128-byte row images, chunk after
// chunk, into the table, in one launch.
//
// Replaces tigerbeetle_tpu/models/ledger.py DeviceLedger._install_fn
// (:2561-2610), driven chunk by chunk by install_snapshot_rows (:2612-2675).
//
// What it computes: the rows split into chunks of `chunk` lanes, in order;
// each chunk's claim rounds (claim.cuh: 4 rounds, lowest lane wins within
// the chunk) see every earlier chunk's rows; each resolved lane's row (and
// fulfill word, for transfers) lands in its slot; the table's count and
// used-slot words grow by the resolved lanes; FAULT_INSTALL is ORed into the
// fault word when an active lane finds no slot. A chunk is not gated on an
// earlier fault (as in the JAX function), and the dump row is never
// written: unresolved lanes write nothing. Slot placement is part of the
// state, so the chunk length is a parameter: the JAX chunk.
//
// Bound on an H100: bytes. Each row is read once and written once (with
// its fulfill word for transfers), and each claim probe reads one 32-byte
// sector of key words and one claim word; there is no arithmetic. What held
// the launch-per-step design back was its 11 launches a chunk (and a host
// call and a scratch allocation a chunk), not bytes.
//
// Design: one launch of one cluster of CLUSTER_BLOCKS blocks of
// CLUSTER_THREADS threads (cluster.cuh: 8192 threads, one lane a thread at
// the restore's chunk of 8192; lane loops stride over the cluster, so any
// chunk length works), looping over the chunks in order. For each chunk:
//   - the claim rounds, with a cluster barrier for each barrier of the rule
//     (cluster.cuh `cluster_claims`, as K3 and K11tf run them, here from
//     round 0); a lane is active when it is below the chunk's length; the
//     table's key words are read past L1, as an earlier chunk wrote them;
//   - each warp moves the rows of its own 32 lanes, eight lanes a row, and
//     writes the fulfill words: the lane's slot comes by a shuffle from the
//     thread that settled it, so no barrier stands before the scatter;
//   - a cluster barrier, before the next chunk's probes.
// Resolved lanes and faults are summed in registers over all chunks and
// added with one atomic a block at the end.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "claim.cuh"
#include "cluster.cuh"
#include "hash.cuh"

namespace cg = cooperative_groups;

struct InstallArgs {
  uint32_t* rows;
  uint32_t* claim;
  int cap_log2;
  uint32_t* fulfill;  // null for accounts
  ull* count;
  ull* used;
  uint32_t* fault;
  const uint32_t* rows_b;  // [n, 32]
  const uint32_t* ful_b;   // [n], null for accounts
  int chunk;
  long long n;
  // scratch, [chunk] each
  int64_t* slot;
  ClaimScratch claim_sc;
};

static InstallArgs carve(char* scratch, int chunk, size_t* size) {
  InstallArgs a{};
  Carver c{scratch, 0};
  a.slot = c.take<int64_t>(chunk);
  a.claim_sc.cand = c.take<int64_t>(chunk);
  a.claim_sc.want = c.take<int32_t>(chunk);
  a.claim_sc.won = c.take<int32_t>(chunk);
  *size = c.off + 256;
  return a;
}

extern "C" size_t tb_install_rows_scratch(int chunk) {
  size_t size;
  carve(nullptr, chunk, &size);
  return size;
}

// Lane i of a chunk of `len` rows is active.
struct Below {
  int len;
  __device__ __forceinline__ bool operator()(int i) const { return i < len; }
};

__global__ void __launch_bounds__(CLUSTER_THREADS, 1) install_chunks(InstallArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ uint32_t want_own[CLAIM_ROUNDS];
  __shared__ unsigned block_ok;
  __shared__ uint32_t block_bad;
  uint32_t* want = cluster.map_shared_rank(want_own, 0);
  const int t = (int)cluster.thread_rank();
  const int stride = (int)cluster.num_threads();
  const int lane = threadIdx.x & 31;
  const RowGroup g = row_group(lane);
  if (threadIdx.x == 0) {
    for (int r = 0; r < CLAIM_ROUNDS; r++) want_own[r] = 0u;
    block_ok = 0u;
    block_bad = 0u;
  }
  cluster.sync();

  unsigned ok_n = 0u;
  uint32_t bad = 0u;
  const long long chunks = (a.n + a.chunk - 1) / a.chunk;
  for (long long c = 0; c < chunks; c++) {
    const long long off = c * a.chunk;
    const int len = (int)min((long long)a.chunk, a.n - off);
    const uint32_t* keys = a.rows_b + off * ROW_WORDS;
    if (cluster_claims<true>(cluster, want, (uint32_t)(c + 1), true, keys, ROW_WORDS, Below{len},
                             len, a.rows, a.claim, a.cap_log2, a.slot, a.claim_sc, nullptr)) {
      bad = FAULT_INSTALL;
    }
    // the scatter: the warp's lanes i0 .. i0 + 31 (this thread settled lane
    // i0 + lane), row j of them by the eight lanes of group j % 4
    for (int i0 = t - lane; i0 < len; i0 += stride) {
      const int i = i0 + lane;
      const bool won = i < len && a.claim_sc.won[i] != 0;
      const long long s = won ? (long long)a.slot[i] : -1ll;
      ok_n += won;
      long long dst[CLUSTER_IN_FLIGHT];
      uint4 v[CLUSTER_IN_FLIGHT];
#pragma unroll
      for (int u = 0; u < CLUSTER_IN_FLIGHT; u++) {
        const int j = (lane >> 3) + 4 * u;
        dst[u] = __shfl_sync(FULL_MASK, s, j);
        if (dst[u] >= 0) {
          v[u] = reinterpret_cast<const uint4*>(keys + (size_t)(i0 + j) * ROW_WORDS)[g.sub];
        }
      }
#pragma unroll
      for (int u = 0; u < CLUSTER_IN_FLIGHT; u++) {
        if (dst[u] < 0) continue;
        reinterpret_cast<uint4*>(a.rows + (size_t)dst[u] * ROW_WORDS)[g.sub] = v[u];
        if (g.sub == 0 && a.fulfill != nullptr) {
          a.fulfill[dst[u]] = a.ful_b[off + i0 + (lane >> 3) + 4 * u];
        }
      }
    }
    cluster.sync();  // this chunk's rows and released claims, before the next probes
  }

  ok_n = __reduce_add_sync(FULL_MASK, ok_n);
  bad = __reduce_or_sync(FULL_MASK, bad);
  if (lane == 0) {
    if (ok_n) atomicAdd(&block_ok, ok_n);
    if (bad) atomicOr(&block_bad, bad);
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    if (block_ok) {
      atomicAdd(a.count, (ull)block_ok);
      atomicAdd(a.used, (ull)block_ok);
    }
    if (block_bad) atomicOr(a.fault, block_bad);
  }
}

// The cluster is non-portable (16 blocks), which a kernel must allow once;
// if that failed, the launch fails and says so.
static void install_allow_cluster() {
  static bool done = cudaFuncSetAttribute(install_chunks,
                                          cudaFuncAttributeNonPortableClusterSizeAllowed,
                                          1) == cudaSuccess;
  (void)done;
}

// rows/claim: the table and its claim column (capacity 1 << cap_log2, plus
// the dump row); fulfill/ful_b: null for accounts; rows_b: [n, 32] row
// images (ful_b [n]), installed in chunks of `chunk` rows in order (one
// chunk of a one-chunk call: n <= chunk); count/used: the table's live count
// and used-slot words; scratch: tb_install_rows_scratch(chunk) bytes.
extern "C" int tb_install_rows(uint32_t* rows, uint32_t* claim, int cap_log2, uint32_t* fulfill,
                               ull* count, ull* used, uint32_t* fault, const uint32_t* rows_b,
                               const uint32_t* ful_b, int chunk, long long n, char* scratch,
                               cudaStream_t stream) {
  if (chunk <= 0 || n < 0 || (fulfill == nullptr) != (ful_b == nullptr))
    return (int)cudaErrorInvalidValue;
  size_t size;
  InstallArgs a = carve(scratch, chunk, &size);
  a.rows = rows;
  a.claim = claim;
  a.cap_log2 = cap_log2;
  a.fulfill = fulfill;
  a.count = count;
  a.used = used;
  a.fault = fault;
  a.rows_b = rows_b;
  a.ful_b = ful_b;
  a.chunk = chunk;
  a.n = n;
  install_allow_cluster();
  launch_cluster(install_chunks, a, stream);
  return (int)cudaGetLastError();
}
