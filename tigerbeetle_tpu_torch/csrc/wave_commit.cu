// K12: the conflict waves of one create_transfers batch, as one launch of
// one thread-block cluster.
//
// Replaces tigerbeetle_tpu/models/ledger.py DeviceLedger._wave_stepper
// (:2261-2291): a lax.scan of the masked fast/fast_pv commit over the W
// wave masks of one uploaded batch, with the waves' codes max-folded. Its
// caller, DeviceLedger._execute_waves, pads W to a bucket (_WAVE_BUCKETS)
// so that XLA compiles a few shapes; here W is a loop count and nothing is
// padded.
//
// Bound on an H100: bytes, as K3's for the batch (each lane is live in one
// wave: its row in, its probe sectors, its account rows, its stored row and
// code out), about 0.0013 ms for 8190 events. The floor that one cluster's
// phases set is W waves of five cluster barriers and their chains of
// dependent loads: a wave's work is its own lanes'.
//
// Design: one kernel over one cluster (cluster.cuh). It first turns
// `wave_of` (one byte a lane, 255 for the lanes of the serial residue and
// the padding) into per-wave lane lists, a stable counting sort over the
// cluster (build_lists): each block counts its slice's lanes per wave in
// shared memory; after one cluster barrier every block reads all blocks'
// counts through distributed shared memory and computes alike each wave's
// start and its own offsets; then it writes its slice's lanes, chunk by
// chunk, warp by warp (__match_any_sync ranks a lane among its warp's lanes
// of the same wave), so each wave's list is in ascending lane order. The
// same pass zeroes the codes of the lanes of no wave (and of lanes >= n).
// Then it loops over the waves and runs K3's phase body (xfer_commit_slot,
// xfer_commit.cuh) over each wave's list (kWaves), as the group commit
// (K5, group_commit.cu) runs it for each slot: every phase strides over
// the wave's entries, or its 2 cnt (event, side) rows, in runs of a warp
// dealt to the 16 blocks in turn (spread_rank: a wave of a few hundred
// lanes runs a warp on each of that many SMs, not all in block 0),
// while scratch words, claims (the lowest lane wins), timestamps and slots
// stay the lane's. Wave w sees the state wave w - 1 left, through the
// barrier that opens each body (whose wait invalidates L1; the claim
// selects read past it, kPastL1, and the lists, which other blocks wrote,
// are read past L1 too), so a post in wave w + 1 finds the pending that
// wave w stored, and a limit account's balance what the waves before it
// applied. A lane's code is written in its own wave. Every wave's
// timestamps are the whole batch's (event_ts(timestamp, n, i)). The gate's
// sticky fault makes every wave after a faulting one a no-op, and its
// capacity guard reads the stored rows that the earlier waves added to
// `used`.
//
// Its blocks are WAVE_THREADS = 256 threads, not K3's 512. The compiler
// hoists the launch's parameters (some 25 pointers and sizes) out of the
// wave loop into registers (the PTX loads them before the loop), where
// K3's body, run once, reads them from the constant bank as it uses them;
// so the loop needs about 220 registers a thread. With 512 threads a block
// (128 registers) and with 384 (168) it spilled; with 256 (up to 255) it
// does not (chip_smoke.py phase 1 prints the build's report). A wave of
// 8190 / W lanes for W >= 2 still takes one pass of the cluster's 4096
// threads.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "xfer_commit.cuh"

namespace cg = cooperative_groups;

#define WAVE_MAX 24  // models/ledger.py WAVE_CAP
#define WAVE_WARPS (WAVE_THREADS / 32)

struct WaveLaunch {
  XferState st;
  XferBatch b;  // b.mask: each lane's wave
  int waves;
  int32_t* lanes;  // [B] the waves' lane lists, wave after wave
};

// A block's shared memory: the phase body's, and the lists' counts.
struct WaveShared {
  XferShared x;
  int count[WAVE_MAX];  // this block's lanes in each wave, read by every block
  int start[WAVE_MAX + 1];  // each wave's first entry, then the total
  int next[WAVE_MAX];  // this block's next entry in each wave
  int warp_at[WAVE_WARPS][WAVE_MAX];  // one chunk's lanes, then offsets, a warp and wave
};

// K12's scratch: K3's (xfer_carve), then the lane lists.
static int32_t* wave_carve(char* scratch, int B, size_t* size) {
  size_t xfer;
  xfer_carve(nullptr, B, &xfer);
  Carver c{scratch, xfer};
  int32_t* lanes = c.take<int32_t>(B);
  *size = c.off + 256;
  return lanes;
}

extern "C" size_t tb_wave_commit_scratch(int B) {
  size_t size;
  wave_carve(nullptr, B, &size);
  return size;
}

// Lane i's wave, -1 for a lane of no wave.
__device__ __forceinline__ int wave_in(const WaveLaunch& p, int i) {
  const int w = i < p.b.n ? (int)p.b.mask[i] : 255;
  return w < p.waves ? w : -1;
}

// The lane lists: wave w's lanes, ascending, at lanes[start[w] ..
// start[w + 1]); every block gets `start` in its shared memory. Block r
// sorts the lanes [r per, (r + 1) per).
__device__ __forceinline__ void build_lists(cg::cluster_group& cluster, const WaveLaunch& p,
                                            WaveShared& sh) {
  const int B = p.st.B, W = p.waves;
  const int rank = (int)cluster.block_rank(), warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int per = (B + CLUSTER_BLOCKS - 1) / CLUSTER_BLOCKS;
  const int lo = min(B, rank * per), hi = min(B, lo + per);
  if (threadIdx.x < WAVE_MAX) sh.count[threadIdx.x] = 0;
  __syncthreads();
  for (int i = lo + threadIdx.x; i < hi; i += WAVE_THREADS) {
    const int w = wave_in(p, i);
    if (w >= 0) {
      atomicAdd(&sh.count[w], 1);
    } else {
      p.b.results[i] = 0;
    }
  }
  cluster.sync();
  if (warp == 0) {  // lane w: wave w's total over the blocks and the blocks before this one
    int total = 0, before = 0;
    if (lane < W) {
      for (int r = 0; r < CLUSTER_BLOCKS; r++) {
        const int c = *cluster.map_shared_rank(&sh.count[lane], (unsigned)r);
        total += c;
        if (r < rank) before += c;
      }
    }
    int incl = total;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int y = __shfl_up_sync(FULL_MASK, incl, o);
      if (lane >= o) incl += y;
    }
    if (lane < W) {
      sh.start[lane] = incl - total;
      sh.next[lane] = incl - total + before;
    }
    if (lane == W - 1) sh.start[W] = incl;
  }
  for (int c0 = lo; c0 < hi; c0 += WAVE_THREADS) {
    const int i = c0 + threadIdx.x;
    const int w = i < hi ? wave_in(p, i) : -1;
    for (int j = threadIdx.x; j < WAVE_WARPS * WAVE_MAX; j += WAVE_THREADS) {
      sh.warp_at[j / WAVE_MAX][j % WAVE_MAX] = 0;
    }
    __syncthreads();
    const unsigned peers = __match_any_sync(FULL_MASK, w);
    const int ahead = __popc(peers & ((1u << lane) - 1u));  // this warp's lanes of w before it
    if (w >= 0 && ahead == 0) sh.warp_at[warp][w] = __popc(peers);
    __syncthreads();
    if ((int)threadIdx.x < W) {  // the warps' offsets for wave threadIdx.x, in warp order
      int at = sh.next[threadIdx.x];
      for (int q = 0; q < WAVE_WARPS; q++) {
        const int c = sh.warp_at[q][threadIdx.x];
        sh.warp_at[q][threadIdx.x] = at;
        at += c;
      }
      sh.next[threadIdx.x] = at;
    }
    __syncthreads();
    if (w >= 0) p.lanes[sh.warp_at[warp][w] + ahead] = i;
    __syncthreads();
  }
}

__global__ void __launch_bounds__(WAVE_THREADS, 1) wave_commit_kernel(WaveLaunch p) {
  cg::cluster_group cluster = cg::this_cluster();
  __shared__ WaveShared sh;
  build_lists(cluster, p, sh);
  __syncthreads();  // sh.start, from warp 0, where build_lists wrote no chunk
  for (int w = 0; w < p.waves; w++) {
    const LaneList list{p.lanes + sh.start[w], sh.start[w + 1] - sh.start[w],
                        spread_rank(cluster, threadIdx.x & 31, 32)};
    xfer_commit_slot<true, true>(cluster, p.st, p.b, sh.x, &list);
  }
}

static void wave_allow_cluster() {
  static bool done = cudaFuncSetAttribute(wave_commit_kernel,
                                          cudaFuncAttributeNonPortableClusterSizeAllowed,
                                          1) == cudaSuccess;
  (void)done;
}

// Commit `batch` ([B, 32] rows, lanes < n) wave by wave, w = 0 .. waves - 1,
// the lanes of wave w those with wave_of[i] == w (a byte a lane), on
// `stream`: codes into `results` [B] (0 for a lane of no wave), the state
// updated in place; `scratch` holds tb_wave_commit_scratch(B) bytes.
extern "C" int tb_wave_commit(uint32_t* acct_rows, int a_log2, uint32_t* xfer_rows, int t_log2,
                              uint32_t* fulfill, uint32_t* xfer_claim, uint32_t* bal_acc,
                              ull* commit_ts, ull* xfer_count, ull* xfer_used, uint32_t* fault,
                              const uint32_t* batch, const uint8_t* wave_of, int B, int n,
                              ull timestamp, int waves, int pv_mode, int32_t* results,
                              char* scratch, cudaStream_t stream) {
  if (waves < 1 || waves > WAVE_MAX || n < 0 || n > B) return (int)cudaErrorInvalidValue;
  WaveLaunch p{};
  p.st = xfer_args(acct_rows, a_log2, xfer_rows, t_log2, fulfill, xfer_claim, bal_acc, commit_ts,
                   xfer_count, xfer_used, fault, B, pv_mode, scratch);
  size_t size;
  p.lanes = wave_carve(scratch, B, &size);
  p.b.batch = batch;
  p.b.mask = wave_of;
  p.b.n = n;
  p.b.timestamp = timestamp;
  p.b.results = results;
  p.waves = waves;
  wave_allow_cluster();
  launch_cluster(wave_commit_kernel, p, stream, WAVE_THREADS);
  return (int)cudaGetLastError();
}
