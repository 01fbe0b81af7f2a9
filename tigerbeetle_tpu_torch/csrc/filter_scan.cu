// K8: the equality filter scan behind the secondary-index queries.
//
// Replaces tigerbeetle_tpu/models/ledger.py LedgerKernels.filter_scan
// (:767-798), called by DeviceLedger._query_scan (:2786-2803).
//
// What it computes, for a table of 1 << cap_log2 slots plus the dump row:
// the live slots (key neither empty nor tombstone; the dump row excluded)
// whose field equals the query value, on `nwords` u32 words from `word0`
// or, for a half-word field, on the low 16 bits of word0; the total match
// count; and the first QUERY_LIMIT matching rows in slot order, padded with
// the dump row's content.
//
// Bound on an H100: bytes. Each slot's key sector (32 bytes) decides
// liveness and the field's sector the match: 64 bytes a slot, 32 when the
// field shares the key's sector (the account ids of a transfer). The output
// is at most 1 MiB of rows. There is no arithmetic to speak of.
//
// Design: compact.cuh's three passes. The count pass is the only one that
// reads the table: it keeps one byte of match bits per slot, so the write
// pass reads 1 byte a slot instead of the sectors again. Then one thread
// per output row gathers the row (eight 16-byte vectors) at its index, or
// the dump row past the total, and thread 0 writes the total.
#include <cuda_runtime.h>

#include "compact.cuh"
#include "hash.cuh"

#define QUERY_LIMIT 8192

struct FieldMatch {
  const uint32_t* rows;
  long long dump;
  int word0, nwords, halfword;
  uint32_t v0, v1, v2, v3;

  __device__ __forceinline__ unsigned operator()(long long i) const {
    if (i == dump) return 0u;
    const uint32_t* p = rows + i * ROW_WORDS;
    Key4 k = key_at(p);
    if (key_empty(k) || key_tomb(k)) return 0u;
    if (halfword) return (p[word0] & 0xFFFFu) == v0 ? 1u : 0u;
    bool m = p[word0] == v0;
    if (nwords > 1) m = m && p[word0 + 1] == v1;
    if (nwords > 2) m = m && p[word0 + 2] == v2 && p[word0 + 3] == v3;
    return m ? 1u : 0u;
  }
};

struct FilterScratch {
  uint8_t* bits;
  int* counts;
  int* totals;
  int32_t* idx;
};

static FilterScratch carve(char* scratch, long long n, size_t* size) {
  FilterScratch a{};
  Carver c{scratch, 0};
  a.bits = c.take<uint8_t>(n);
  a.counts = c.take<int>(compact_blocks(n));
  a.totals = c.take<int>(1);
  a.idx = c.take<int32_t>(QUERY_LIMIT);
  *size = c.off + 256;
  return a;
}

extern "C" size_t tb_filter_scan_scratch(int cap_log2) {
  size_t size;
  carve(nullptr, (1ll << cap_log2) + 1, &size);
  return size;
}

__global__ void filter_gather(const uint32_t* __restrict__ rows, long long dump,
                              const int32_t* __restrict__ idx, const int* __restrict__ totals,
                              uint32_t* __restrict__ out_rows, int32_t* __restrict__ out_total) {
  int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= QUERY_LIMIT) return;
  int total = totals[0];
  long long s = i < total ? (long long)idx[i] : dump;
  store_row(out_rows + (size_t)i * ROW_WORDS, load_row(rows + s * ROW_WORDS));
  if (i == 0) *out_total = total;
}

// rows: the table ((1 << cap_log2) + 1 rows, the last the dump row);
// (word0, nwords, halfword): the field; v: the value's u32 words, low first;
// out_rows: [QUERY_LIMIT, 32]; out_total: one int32; scratch:
// tb_filter_scan_scratch(cap_log2) bytes.
extern "C" int tb_filter_scan(const uint32_t* rows, int cap_log2, int word0, int nwords,
                              int halfword, uint32_t v0, uint32_t v1, uint32_t v2, uint32_t v3,
                              uint32_t* out_rows, int32_t* out_total, char* scratch,
                              cudaStream_t stream) {
  if (word0 < 0 || nwords < 1 || nwords > 4 || nwords == 3 || word0 + nwords > ROW_WORDS)
    return (int)cudaErrorInvalidValue;
  long long dump = 1ll << cap_log2, n = dump + 1;
  size_t size;
  FilterScratch a = carve(scratch, n, &size);
  FieldMatch pred{rows, dump, word0, nwords, halfword, v0, v1, v2, v3};
  CompactOut out{};
  out.idx[0] = a.idx;
  out.limit[0] = QUERY_LIMIT;
  compact_run<1>(pred, n, a.bits, a.counts, a.totals, out, stream);
  filter_gather<<<QUERY_LIMIT / 256, 256, 0, stream>>>(rows, dump, a.idx, a.totals, out_rows,
                                                       out_total);
  return (int)cudaGetLastError();
}
