// K10, the spill cycle's row movers: gather and reload.
//
// Replaces tigerbeetle_tpu/models/spill.py SpillKernels._gather and _reload
// (:271-305), called by SpillManager._cycle (:859-925: the cold rows'
// gather to the host, the hot tail's rebuild into a fresh table) and
// _reload_rows (:721-753: spilled rows a batch references, back into the
// live table).
//
// - tb_spill_gather: rows and fulfill words at an index list of any length
//   (the dump slot is a valid index; its content comes out as it is). The
//   cycle calls it once for each side: the cold rows into a staging buffer
//   for the host, the hot rows, padded with the dump slot to whole chunks,
//   for the rebuild.
// - tb_spill_reload: a chunk of stored rows back into a table, verbatim,
//   fulfill word included. Lanes whose key is already resident are skipped
//   (reload is idempotent); the absent active keys claim slots with the
//   JAX rule (4 rounds, lowest lane wins, claim.cuh). The chunk is
//   all-or-nothing: PROBE (an active lane's lookup window ran out), CLAIM
//   (a lane found no slot) and CAPACITY (used_slots + new rows > half the
//   slots) OR into the sticky fault word, and any fault, earlier ones
//   included, leaves the table, fulfill and used_slots as they were. Then
//   `probe` = (u32)used_slots ^ fault, the word the host's staging fence
//   waits on. The dump row is never written.
// - tb_spill_reload_chunks: the rebuild's whole hot side, rows [n, 32], in
//   chunks of `chunk` rows, each exactly as one tb_spill_reload call on its
//   slice with the lanes below its length active, chunk after chunk: a
//   chunk's probes and claims see every earlier chunk's rows, used_slots
//   carries over, and a chunk after a fault still probes, claims and
//   releases, ORs its PROBE and CLAIM bits and tests CAPACITY against the
//   unchanged used_slots, and writes nothing (as the JAX cycle's chunk loop
//   does, every reload gated on the sticky fault word).
//
// Bound on an H100: bytes. A reload chunk of 8192 moves 8192 x 132 bytes
// in and the same out, plus one key sector per probe. Gather moves its rows
// and fulfill words once each way and reads its indices: (4 + 2 x 132)
// bytes a row, 0.031 ms over 3.35 TB/s for the 393 K cold rows of a cycle
// at 2^20 transfer slots. At 8192 rows the bound is 0.00066 ms, far below
// a launch and its wrapper (tens of us): launches, not bytes, bound a
// chunk, so a chunk is one launch and a rebuild's chunks are one too.
//
// Design: gather is one grid-stride launch of about two blocks an SM over
// the whole list. Eight lanes move a row as 16-byte vectors, so a warp
// moves four rows a step, and each warp keeps GATHER_UNROLL steps (16 rows,
// 2 KiB) in flight: it loads its 16 indices coalesced, one lane each,
// shuffles them to the row groups, issues all 16 row loads, then stores the
// rows and, from the index lanes, the fulfill words.
//
// Reload, one chunk or all of them, is one launch of one cluster of
// CLUSTER_BLOCKS blocks of CLUSTER_THREADS threads (cluster.cuh: 8192
// threads, one lane a thread at CHUNK = 8192), looping over the chunks in
// order; a one-chunk call is a loop of one. For each chunk, with a cluster
// barrier where a kernel boundary stood:
//   (a) each active lane's probe (K1's lookup, window 32) marks `need`
//       (absent) and the unresolved lanes; round 0 of the claims folds in:
//       the claim column is all free at a chunk's start (every claimant
//       releases before the chunk ends), so its pick is the window's first
//       free slot, found by the same probe, and its atomicMin follows;
//   (b) claim rounds 1-3, settle and release (cluster.cuh
//       `cluster_claims`, as K3, K11tf and K9 run them), the chunk's index
//       + 1 as the epoch of the rounds' flags;
//   (c) the gate: each block sums its warps' needing lanes and ORs their
//       PROBE and CLAIM bits into its own shared words (32-bit atomics in
//       the block; a cluster-wide 64-bit atomic through map_shared_rank
//       lost updates on an H100, xfer_commit.cuh), and after the barrier
//       one warp of every block reads all the blocks' words and decides
//       alike: fault =
//       fault | bits | CAPACITY if used + n_new > half, proceed iff fault
//       is 0, used += n_new if so. The running fault and used words stay in
//       every block's shared memory; one thread writes them and `probe`
//       once, after the last chunk;
//   (d) if the gate passed, each warp moves the rows of its own 32 lanes
//       that won a slot, eight lanes a row (as K9), and their fulfill
//       words; then a cluster barrier before the next chunk's probes.
// A later chunk reads rows an earlier one wrote from other SMs: its probes
// and claim selects read the table's key words past L1 (ld.global.cg), as
// K9's chunks and K5's claim selects do, and each cluster barrier's wait
// is followed by an L1 invalidation in the SASS (chip_smoke.py checks it).
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "claim.cuh"
#include "cluster.cuh"
#include "hash.cuh"

// ---------------------------------------------------------------- gather

#define GATHER_THREADS 256
#define GATHER_UNROLL 4                  // steps of four rows a warp has in flight
#define GATHER_ROWS (4 * GATHER_UNROLL)  // rows a warp moves per turn
#define GATHER_BLOCKS_PER_SM 2

__global__ void __launch_bounds__(GATHER_THREADS) spill_gather_kernel(
    const uint32_t* __restrict__ rows, const uint32_t* __restrict__ fulfill,
    const int32_t* __restrict__ idx, long long B, uint32_t* __restrict__ out_rows,
    uint32_t* __restrict__ out_ful) {
  const int lane = threadIdx.x & 31;
  const int sub = lane & 7, quad = lane >> 3;  // piece of the row, row of the step
  const long long warp = ((long long)blockIdx.x * GATHER_THREADS + threadIdx.x) >> 5;
  const long long n_warps = ((long long)gridDim.x * GATHER_THREADS) >> 5;
  for (long long base = warp * GATHER_ROWS; base < B; base += n_warps * GATHER_ROWS) {
    const bool mine = lane < GATHER_ROWS && base + lane < B;
    const int my_slot = mine ? __ldg(idx + base + lane) : 0;
    uint4 v[GATHER_UNROLL];
#pragma unroll
    for (int u = 0; u < GATHER_UNROLL; u++) {
      const int r = 4 * u + quad;
      const long long s = __shfl_sync(0xFFFFFFFFu, my_slot, r);
      if (base + r < B) {
        v[u] = __ldg(reinterpret_cast<const uint4*>(rows + s * ROW_WORDS) + sub);
      }
    }
    const uint32_t ful = mine ? __ldg(fulfill + my_slot) : 0u;
#pragma unroll
    for (int u = 0; u < GATHER_UNROLL; u++) {
      const long long r = base + 4 * u + quad;
      if (r < B) reinterpret_cast<uint4*>(out_rows + r * ROW_WORDS)[sub] = v[u];
    }
    if (mine) out_ful[base + lane] = ful;
  }
}

// rows/fulfill: the table and its fulfill column; idx: int32 [B] slots (each
// at most the dump slot, checked by the caller); out_rows [B, 32], out_ful [B].
extern "C" int tb_spill_gather(const uint32_t* rows, const uint32_t* fulfill, const int32_t* idx,
                               long long B, uint32_t* out_rows, uint32_t* out_ful,
                               cudaStream_t stream) {
  if (B > 0) {
    static int sms = 0;
    if (sms == 0) {
      int dev = 0;
      cudaGetDevice(&dev);
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
      if (sms <= 0) sms = 1;
    }
    const long long rows_a_block = (long long)GATHER_ROWS * (GATHER_THREADS / 32);
    const long long needed = (B + rows_a_block - 1) / rows_a_block;
    const long long most = (long long)GATHER_BLOCKS_PER_SM * sms;
    const int grid = (int)(needed < most ? needed : most);
    spill_gather_kernel<<<grid, GATHER_THREADS, 0, stream>>>(rows, fulfill, idx, B, out_rows,
                                                            out_ful);
  }
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------- reload

namespace cg = cooperative_groups;

struct ReloadArgs {
  uint32_t* rows;
  uint32_t* fulfill;
  uint32_t* claim;
  int cap_log2;
  ull* used;
  uint32_t* fault;
  uint32_t* probe;
  const uint32_t* rows_b;  // [rows, 32] stored rows, chunk after chunk
  const uint32_t* ful_b;
  const uint8_t* active;  // one chunk: lane i active where nonzero; null: rows below n
  int chunk;              // lanes a chunk
  long long n;            // rows (null `active`)
  long long n_chunks;
  // scratch, [chunk] each
  int32_t* need;  // active and not resident: claims a slot
  int64_t* slot;
  ClaimScratch claim_sc;
};

static ReloadArgs carve(char* scratch, int chunk, size_t* size) {
  ReloadArgs a{};
  Carver c{scratch, 0};
  a.need = c.take<int32_t>(chunk);
  a.slot = c.take<int64_t>(chunk);
  a.claim_sc.cand = c.take<int64_t>(chunk);
  a.claim_sc.want = c.take<int32_t>(chunk);
  a.claim_sc.won = c.take<int32_t>(chunk);
  *size = c.off + 256;
  return a;
}

extern "C" size_t tb_spill_reload_scratch(int chunk) {
  size_t size;
  carve(nullptr, chunk, &size);
  return size;
}

// A block's shared words: block 0's `want` flags serve the cluster; the
// block's sums for chunk c sit in [c & 1] (the other pair is cleared while
// chunk c runs, after every block has read it); the gate's running words
// are the same in every block.
struct ReloadShared {
  uint32_t want[CLAIM_ROUNDS];
  uint32_t n_new[2], bad[2];
  ull used;
  uint32_t fault, proceed;
};

// K1's lookup of one key with the table's key words read past L1, and the
// window's first free (empty or tombstone) position, -1 if none: round 0's
// pick, the claim column being all free.
struct ReloadProbe {
  bool found, resolved;
  int64_t free_pos;
};

__device__ __forceinline__ ReloadProbe reload_probe(const uint32_t* rows, int cap_log2,
                                                    const Key4& key) {
  const Probe pr = probe_of(key, cap_log2);
  const bool probeable = !key_empty(key) && !key_tomb(key);
  int64_t free_pos = -1;
  for (int j = 0; j < WINDOW; j++) {
    const uint32_t p = pr.at(j);
    const Key4 k = key_at_cg(rows + (size_t)p * ROW_WORDS);
    if (probeable && key_eq(k, key)) return ReloadProbe{true, true, free_pos};
    const bool empty = key_empty(k);
    if (free_pos < 0 && (empty || key_tomb(k))) free_pos = p;
    if (empty) return ReloadProbe{false, true, free_pos};
  }
  return ReloadProbe{false, false, free_pos};
}

__global__ void __launch_bounds__(CLUSTER_THREADS, 1) reload_chunks(ReloadArgs a) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ ReloadShared sh;
  uint32_t* want = cluster.map_shared_rank(sh.want, 0);
  const int t = (int)cluster.thread_rank();
  const int stride = (int)cluster.num_threads();
  const int lane = threadIdx.x & 31;
  const unsigned nb = cluster.num_blocks();
  const RowGroup g = row_group(lane);
  const int64_t dump = (int64_t)1 << a.cap_log2;
  const ull half = (1ull << a.cap_log2) / 2;
  const ClaimScratch& sc = a.claim_sc;
  if (threadIdx.x == 0) {
    for (int r = 0; r < CLAIM_ROUNDS; r++) sh.want[r] = 0u;
    sh.n_new[0] = sh.n_new[1] = 0u;
    sh.bad[0] = sh.bad[1] = 0u;
    sh.used = *a.used;
    sh.fault = *a.fault;
  }
  cluster.sync();

  for (long long c = 0; c < a.n_chunks; c++) {
    const int par = (int)(c & 1);
    const long long off = c * a.chunk;
    const int len = a.active != nullptr ? a.chunk : (int)min((long long)a.chunk, a.n - off);
    const uint32_t* keys = a.rows_b + off * ROW_WORDS;
    const uint32_t epoch = (uint32_t)(c + 1);
    if (threadIdx.x == 0) {  // every block read them in the previous chunk's gate
      sh.n_new[par ^ 1] = 0u;
      sh.bad[par ^ 1] = 0u;
    }

    // (a) probes, and claim round 0
    unsigned n_new = 0u;
    bool unresolved = false, wants = false;
    for (int i = t; i < len; i += stride) {
      sc.won[i] = 0;
      sc.want[i] = 0;
      a.slot[i] = dump;
      bool nd = false;
      if (a.active == nullptr || a.active[i] != 0) {
        const ReloadProbe f =
            reload_probe(a.rows, a.cap_log2, key_at(keys + (size_t)i * ROW_WORDS));
        nd = !f.found;
        unresolved |= !f.resolved;
        if (nd && f.free_pos >= 0) {
          sc.cand[i] = f.free_pos;
          sc.want[i] = 1;
          atomicMin(a.claim + f.free_pos, (uint32_t)i);
          wants = true;
        }
      }
      a.need[i] = nd;
      n_new += nd;
    }
    n_new = __reduce_add_sync(FULL_MASK, n_new);
    const bool any_unresolved = __any_sync(FULL_MASK, unresolved);
    if (__any_sync(FULL_MASK, wants) && lane == 0) atomicMax(want, epoch);
    if (lane == 0) {
      if (n_new) atomicAdd(&sh.n_new[par], n_new);
      if (any_unresolved) atomicOr(&sh.bad[par], FAULT_PROBE);
    }
    cluster.sync();

    // (b) claim rounds 1.., settle and release
    uint32_t bad = cluster_claims<true>(cluster, want, epoch, false, keys, ROW_WORDS, a.need, len,
                                        a.rows, a.claim, a.cap_log2, a.slot, sc, nullptr);
    bad = __reduce_or_sync(FULL_MASK, bad);
    if (lane == 0 && bad) atomicOr(&sh.bad[par], bad);
    cluster.sync();

    // (c) the gate over every block's words, decided alike in each block
    if (threadIdx.x < 32) {
      uint32_t nw = 0u, bw = 0u;
      if ((unsigned)lane < nb) {
        nw = *cluster.map_shared_rank(&sh.n_new[par], (unsigned)lane);
        bw = *cluster.map_shared_rank(&sh.bad[par], (unsigned)lane);
      }
      nw = __reduce_add_sync(FULL_MASK, nw);
      bw = __reduce_or_sync(FULL_MASK, bw);
      if (lane == 0) {
        const uint32_t f = sh.fault | bw | (sh.used + nw > half ? FAULT_CAPACITY : 0u);
        sh.fault = f;
        if (f == 0u) sh.used += nw;
        sh.proceed = f == 0u;
      }
    }
    __syncthreads();

    // (d) the scatter: the warp's lanes i0 .. i0 + 31 (this thread settled
    // lane i0 + lane), row j of them by the eight lanes of group j % 4
    if (sh.proceed) {
      for (int i0 = t - lane; i0 < len; i0 += stride) {
        const int i = i0 + lane;
        const long long s = i < len && sc.won[i] != 0 ? (long long)a.slot[i] : -1ll;
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
          if (g.sub == 0) a.fulfill[dst[u]] = a.ful_b[off + i0 + (lane >> 3) + 4 * u];
        }
      }
    }
    cluster.sync();  // this chunk's rows and released claims, before the next probes
  }

  if (cluster.block_rank() == 0 && threadIdx.x == 0) {
    *a.fault = sh.fault;
    *a.used = sh.used;
    *a.probe = (uint32_t)sh.used ^ sh.fault;
  }
}

// The cluster is non-portable (16 blocks), which a kernel must allow once;
// if that failed, the launch fails and says so.
static void reload_allow_cluster() {
  static bool done = cudaFuncSetAttribute(reload_chunks,
                                          cudaFuncAttributeNonPortableClusterSizeAllowed,
                                          1) == cudaSuccess;
  (void)done;
}

static int reload_launch(ReloadArgs a, cudaStream_t stream) {
  reload_allow_cluster();
  launch_cluster(reload_chunks, a, stream);
  return (int)cudaGetLastError();
}

static ReloadArgs reload_args(uint32_t* rows, uint32_t* fulfill, uint32_t* claim, int cap_log2,
                              ull* used, uint32_t* fault, const uint32_t* rows_b,
                              const uint32_t* ful_b, int chunk, uint32_t* probe, char* scratch) {
  size_t size;
  ReloadArgs a = carve(scratch, chunk, &size);
  a.rows = rows;
  a.fulfill = fulfill;
  a.claim = claim;
  a.cap_log2 = cap_log2;
  a.used = used;
  a.fault = fault;
  a.probe = probe;
  a.rows_b = rows_b;
  a.ful_b = ful_b;
  a.chunk = chunk;
  return a;
}

// rows/fulfill/claim: the transfer table ((1 << cap_log2) + 1 rows), its
// fulfill and claim columns; used: its used-slot word; fault: the sticky
// fault word; rows_b [B, 32], ful_b [B]: the stored rows; active [B]: the
// lanes to reload; probe: one u32 out; scratch: tb_spill_reload_scratch(B).
extern "C" int tb_spill_reload(uint32_t* rows, uint32_t* fulfill, uint32_t* claim, int cap_log2,
                               ull* used, uint32_t* fault, const uint32_t* rows_b,
                               const uint32_t* ful_b, const uint8_t* active, int B,
                               uint32_t* probe, char* scratch, cudaStream_t stream) {
  if (B <= 0 || active == nullptr) return (int)cudaErrorInvalidValue;
  ReloadArgs a = reload_args(rows, fulfill, claim, cap_log2, used, fault, rows_b, ful_b, B, probe,
                             scratch);
  a.active = active;
  a.n = B;
  a.n_chunks = 1;
  return reload_launch(a, stream);
}

// The same table arguments; rows_b [n, 32] and ful_b [n]: the stored rows,
// reloaded in chunks of `chunk` rows in order (the last one partial),
// each chunk's lanes below its length active; scratch:
// tb_spill_reload_scratch(chunk). With n = 0 only `probe` is written.
extern "C" int tb_spill_reload_chunks(uint32_t* rows, uint32_t* fulfill, uint32_t* claim,
                                      int cap_log2, ull* used, uint32_t* fault,
                                      const uint32_t* rows_b, const uint32_t* ful_b, long long n,
                                      int chunk, uint32_t* probe, char* scratch,
                                      cudaStream_t stream) {
  if (chunk <= 0 || n < 0) return (int)cudaErrorInvalidValue;
  ReloadArgs a = reload_args(rows, fulfill, claim, cap_log2, used, fault, rows_b, ful_b, chunk,
                             probe, scratch);
  a.n = n;
  a.n_chunks = (n + chunk - 1) / chunk;
  return reload_launch(a, stream);
}
