// K3's launch sequence as a host function, so that the group commit (K5,
// group_commit.cu) enqueues it once per slot (commit_transfers.cu).
#pragma once
#include <cuda_runtime.h>

#include <cstdint>

#include "rows.cuh"

// Enqueue the fast / fast_pv commit of `batch` ([B, 32] rows, lanes < n,
// and in `mask` if it is not null) on `stream`: codes into `results` [B],
// the state updated in place. `scratch` holds
// tb_commit_transfers_fast_scratch(B) bytes and may be reused by the next
// enqueue on the same stream. Launch errors are left for cudaGetLastError.
void xfer_fast_enqueue(uint32_t* acct_rows, int a_log2, uint32_t* xfer_rows, int t_log2,
                       uint32_t* fulfill, uint32_t* xfer_claim, uint32_t* bal_acc, ull* commit_ts,
                       ull* xfer_count, ull* xfer_used, uint32_t* fault, const uint32_t* batch,
                       const uint8_t* mask, int B, int n, ull timestamp, int pv_mode,
                       int32_t* results, char* scratch, cudaStream_t stream);
