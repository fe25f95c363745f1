// Shared plumbing of the scan kernels: tile walk, window ownership and the
// per-pattern count reduction.
//
// Both kernels read the staged rows that apm_torch.ops.common.fold_corpus
// builds (row r = corpus bytes [start + r*wf, start + r*wf + wf + halo)).
// Window j = start + r*wf + lane (lane < wf) belongs to row r. A block walks
// tiles of kTile windows of one row, one window per thread, grid-stride over
// all (row, tile) pairs, so the grid is sized to the card and not to the
// corpus. Counts are reduced per pattern in shared memory over everything
// the block scanned, then added to the (P,) output with one integer atomic
// per pattern and block (integer atomics: the sum does not depend on order).
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace apm {

// Threads per block; each thread scans one window of a tile.
constexpr int kTile = 256;

// Row r owns lanes [0, limit): windows below the global bound, rows below
// n_rows (rows at or past it are staging padding and own nothing).
__device__ __forceinline__ int64_t owned_limit(int64_t r, int64_t n_rows,
                                               int64_t wf, int64_t bound,
                                               int64_t start) {
  if (r >= n_rows) return 0;
  const int64_t lim = bound - start - r * wf;
  return lim < 0 ? 0 : (lim > wf ? wf : lim);
}

__device__ __forceinline__ void zero_counts(int* s_cnt, int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) s_cnt[i] = 0;
}

// Adds this warp's hits for pattern p to the block's shared counter. Every
// thread of the warp must call it (full-mask warp reduction).
__device__ __forceinline__ void add_hits(int* s_cnt, int p, int hit) {
  const unsigned w = __reduce_add_sync(0xffffffffu, (unsigned)hit);
  if ((threadIdx.x & 31) == 0 && w != 0) atomicAdd(&s_cnt[p], (int)w);
}

__device__ __forceinline__ void flush_counts(const int* s_cnt, int32_t* out,
                                             int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    if (s_cnt[i] != 0) atomicAdd(&out[i], s_cnt[i]);
  }
}

}  // namespace apm
