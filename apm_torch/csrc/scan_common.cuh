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
// The batch modes (many corpora in one launch) take each row's ownership
// from a per-block or per-row table instead and flush their counters into
// the tile's row-block slot after every tile. Kernels A and C (and their
// batch modes) walk tiles this way and reduce with add_hits; the mask
// kernels (#6, dp_mask.cu) walk tiles of two windows a thread, staged in
// shared memory, and reduce with add_hits too;
// kernel B (both modes) and kernel #7 walk tiles of windows per thread
// instead (exact_scan.cuh), and kernel D its own items of 32-window tiles
// (filter_pieces.cu); they use only the ownership and flush helpers here.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace apm {

// Threads per block; each thread scans one window of a tile.
constexpr int kTile = 256;

// Staged rows per block of the batch modes (apm's int32 fold): a batch
// carries one [bound, start] pair and one count slot per kFold rows.
constexpr int kFold = 8;

__device__ __forceinline__ int64_t clip_lanes(int64_t lim, int64_t wf) {
  return lim < 0 ? 0 : (lim > wf ? wf : lim);
}

// Row r owns lanes [0, limit): windows below the global bound, rows below
// n_rows (rows at or past it are staging padding and own nothing).
__device__ __forceinline__ int64_t owned_limit(int64_t r, int64_t n_rows,
                                               int64_t wf, int64_t bound,
                                               int64_t start) {
  if (r >= n_rows) return 0;
  return clip_lanes(bound - start - r * wf, wf);
}

// Batch mode: row r of block b = r / kFold owns the windows
// meta[b][1] + (r % kFold)*wf + lane below meta[b][0]. Each corpus of a
// batch has its own virtual window space (start = block index * w), and
// padding blocks carry bound 0.
__device__ __forceinline__ int64_t batch_limit(const int32_t* meta,
                                               int64_t r, int64_t wf) {
  const int64_t b = r / kFold;
  return clip_lanes((int64_t)meta[2 * b] - meta[2 * b + 1] - (r % kFold) * wf,
                    wf);
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

// Batch modes: after each tile, add the block's counters to the tile's
// row-block slot and zero them (one atomic per nonzero (slot, pattern)).
// Every thread of the block calls it between two __syncthreads().
__device__ __forceinline__ void flush_and_reset(int* s_cnt, int32_t* out,
                                                int n) {
  for (int i = threadIdx.x; i < n; i += blockDim.x) {
    const int v = s_cnt[i];
    if (v != 0) {
      atomicAdd(&out[i], v);
      s_cnt[i] = 0;
    }
  }
}

}  // namespace apm
