// Exact-match (k = 0) window count (kernel B).
//
// Replaces apm/ops/corr_fused.py::scan_corr_fused (kernel body
// _fused_kernel). Same contract: staged rows (R, wf + halo) uint8, the
// global window bound and start, n_rows; row r < n_rows owns lanes
// [0, clip(bound - start - r*wf, 0, wf)), and an owned window j counts for
// pattern slot p iff the text at j equals pattern p over all m_p bytes.
// That is exactly what the TPU kernel's certificate corr >= B * m_p states:
// bytes outside the pattern alphabet encode to zero planes there and can
// never reach the threshold, and the pattern bytes are the alphabet.
// Sentinel slots (threshold 2^30 on the TPU) arrive here with m_p = 0 and
// never count. The pattern bytes are decoded on the host from the TPU
// tables (km, thr, alphabet), so loaded tables drive this kernel too.
//
// What bounds it on an H100: memory and issue are both light. A window
// costs about 1 + 1/|alphabet| byte compares per pattern on random text
// before the first mismatch, so at a few patterns the kernel is bound by
// reading the staged rows once (HBM) and by the per-pattern loop overhead.
//
// Design: the TPU formulation (phase-split im2col, ±1 bit-planes, a matmul
// per 128-byte K-tile) exists to feed the MXU; a per-window compare with
// early exit needs none of it. One thread per window, text bytes read
// through L1 (consecutive threads on consecutive bytes), pattern bytes the
// same address for the whole block, counts reduced per pattern in shared
// memory. A tensor-core formulation is later work. Staging padding (rows
// at or past n_rows, windows past the bound) is masked by ownership, which
// keeps a NUL byte in the alphabet exact.
#include "scan_common.cuh"

namespace {

using apm::kTile;

struct CorrArgs {
  const uint8_t* rows;  // (n_staged, row_stride) staged corpus rows
  int64_t n_staged;
  int64_t row_stride;   // wf + halo
  int64_t n_rows;       // rows carrying real windows
  const uint8_t* pat;   // (n_pat, pat_stride) pattern bytes
  int n_pat;
  int64_t pat_stride;
  const int32_t* plens; // (n_pat,) pattern lengths, 0 = sentinel slot
  int64_t wf;
  int64_t bound;
  int64_t start;
  int32_t* out;         // (n_pat,) counts, accumulated with atomics
};

__global__ void __launch_bounds__(kTile) corr_fused_kernel(CorrArgs a) {
  extern __shared__ int s_cnt[];
  apm::zero_counts(s_cnt, a.n_pat);
  __syncthreads();

  const int64_t rows = a.n_rows < a.n_staged ? a.n_rows : a.n_staged;
  const int64_t tiles_per_row = (a.wf + kTile - 1) / kTile;
  const int64_t n_tiles = rows * tiles_per_row;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t r = t / tiles_per_row;
    const int64_t lane0 = (t - r * tiles_per_row) * kTile;
    const int64_t limit =
        apm::owned_limit(r, a.n_rows, a.wf, a.bound, a.start);
    if (lane0 >= limit) continue;  // uniform over the block
    const int64_t lane = lane0 + threadIdx.x;
    const bool own = lane < limit;
    const uint8_t* __restrict__ txt = a.rows + r * a.row_stride + lane;
    for (int p = 0; p < a.n_pat; ++p) {
      const int m = a.plens[p];
      if (m <= 0) continue;  // sentinel slot: never counts
      int hit = 0;
      if (own) {
        const uint8_t* __restrict__ pp = a.pat + (int64_t)p * a.pat_stride;
        int i = 0;
        while (i < m && txt[i] == pp[i]) ++i;
        hit = i == m ? 1 : 0;
      }
      apm::add_hits(s_cnt, p, hit);
    }
  }
  __syncthreads();
  apm::flush_counts(s_cnt, a.out, a.n_pat);
}

}  // namespace

// Adds each slot's exact-match count to out[p] (the caller zeroes out).
// Returns the launch's cudaError_t (0 on success).
extern "C" int apm_corr_fused_count(const uint8_t* rows, int64_t n_staged,
                                    int64_t row_stride, int64_t n_rows,
                                    const uint8_t* pat, int n_pat,
                                    int64_t pat_stride, const int32_t* plens,
                                    int64_t wf, int64_t bound, int64_t start,
                                    int32_t* out, int grid, void* stream) {
  CorrArgs a{rows, n_staged, row_stride, n_rows, pat,   n_pat, pat_stride,
             plens, wf,      bound,      start,  out};
  if (grid <= 0 || n_pat <= 0) return (int)cudaErrorInvalidValue;
  corr_fused_kernel<<<grid, kTile, n_pat * sizeof(int),
                      (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
