// Bit-parallel banded window count (kernel C).
//
// Replaces apm/ops/pallas_kernel.py::_scan_folded_pallas_unrolled in Myers
// mode (kernel body _scan_kernel_unrolled -> _myers_phases, PEQ table from
// _build_peq, gate _myers_mode). Same contract as kernel A (dp_band.cu):
// staged rows (R, wf + halo) uint8 and per-pattern lengths; window j =
// start + r*wf + lane (lane < wf) counts for pattern p iff j < bound and
// the band's centre value after m_p steps is <= k. The band's 2k + 1 cells
// are vertical-delta bit vectors VP/VN (B = 2k + 1 <= 29 bits) plus the
// centre value; each step is Hyyro's update over the match word
// PEQ[p*m_max + row][channel(text byte)] (bit b set iff the k-padded
// pattern byte at row + b equals the channel's byte). Three phases, as on
// the TPU: static (x = 1..min(k, m), PEQ row k, centre bit x - 1), the
// conversion at x = k (VP = VP << 1 | 1, VN <<= 1), moving (x = k+1..m,
// VP = VP >> 1 | topbit, VN >>= 1, PEQ row x - 1, centre bit k). The
// centre value is exact whenever it is <= k, so the verdict equals band
// mode's for every window.
//
// What bounds it on an H100: integer issue, Hyyro's update a step per
// pattern whatever k is, plus one shared-memory load of the match word.
//
// Design: dp_pair.cuh's tile walk and bit bands, shared with the mask
// kernel #6 (dp_mask.cu): two windows a thread; each 512-window tile's
// text is translated once to alphabet channels in shared memory (bytes
// outside the alphabet to a zero PEQ column, so a step has no branch) and
// every pattern is scanned from it; up to k = 7 the two windows share one
// VP/VN/centre word (16-bit fields), wider bands run two chains a thread.
// The PEQ table (at most 64 KB under apm's gate, plus the zero column)
// and the tile's channels share the dynamic shared memory. Ownership and
// counting are kernel A's (apm::owned_limit, shared per-pattern counters,
// 0, 1 or 2 hits a thread and pattern). The window bound is a value or,
// for phase-2 verification, read from device memory.
//
// The batch mode (apm_dp_myers_batch, _scan_folded_pallas_batch in Myers
// mode, TPU kernel #4) is kernel A's: per-block [bound, start] pairs with
// an (R/8, P) count output, flushed after every tile.
#include "dp_pair.cuh"

using namespace apm::pair;

namespace {

__global__ void __launch_bounds__(kThreads, kMyersBlocks) dp_myers_kernel(Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  const MyersSmem s = load_myers(a, smem);

  const int64_t bound = a.dbound != nullptr ? *a.dbound : a.bound;
  const int64_t tpr = tiles_per_row(a);
  const int64_t n_tiles = a.n_rows * tpr;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t r = t / tpr;
    const int64_t lane0 = (t - r * tpr) * kWin;
    const int64_t limit = row_limit(a, r, bound, a.start);
    __syncthreads();  // the LUT (first tile); every thread done with the last tile and counters
    if (lane0 < limit) {  // uniform over the block
      stage_channels(a, r, lane0, s);
      __syncthreads();
      const int64_t lane = lane0 + 2 * threadIdx.x;
      const int own = (lane < limit ? 1 : 0) | (lane + 1 < limit ? 2 : 0);
      for (int p = 0; p < a.n_pat; ++p) {
        const int m = s.plen[p];
        if (m <= 0) continue;  // uniform: a padding slot
        const int hits = own != 0 ? myers_hits(a, s, p, m, own) : 0;
        apm::add_hits(s.cnt, p, (hits & 1) + (hits >> 1));
      }
      if (a.meta != nullptr) {
        __syncthreads();
        apm::flush_and_reset(s.cnt, a.out + (r / apm::kFold) * a.out_stride, a.n_pat);
      }
    }
  }
  if (a.meta == nullptr) {
    __syncthreads();
    apm::flush_counts(s.cnt, a.out, a.n_pat);
  }
}

Args myers_args(const uint8_t* rows, int64_t n_rows, int64_t row_stride, const int32_t* peq,
                int n_pat, int m_max, int n_chan, const uint8_t* alph, const int32_t* plens, int k,
                int64_t wf, int64_t bound, const int64_t* dbound, int64_t start, int32_t* out) {
  Args a = base_args(rows, n_rows, row_stride, n_pat, m_max, plens, k, wf, bound, dbound, start,
                     out);
  a.peq = peq;
  a.alph = alph;
  a.n_chan = n_chan;
  a.packed = 2 * k + 1 <= 15;
  return a;
}

int run(const Args& a, int grid, void* stream) {
  if (bad_myers(a.n_rows, a.n_pat, a.m_max, a.n_chan, a.k, a.wf) ||
      a.row_stride < a.wf + a.m_max - 1) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = myers_smem(a);
  int g = 0;
  cudaError_t e = pair_grid(n_tiles(a), kMyersBlocks, grid, &g);
  if (e == cudaSuccess) e = allow_smem(dp_myers_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  dp_myers_kernel<<<g, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Adds each pattern's window count to out[p] (the caller zeroes out).
// `dbound`, when not null, points at an int64 window bound in device memory
// that replaces `bound`. 1 <= k, 2k + 1 <= 29, k < m_max, 1 <= n_chan <= 32.
// One launch; its grid is sized here, at most `grid` blocks when `grid` is
// positive. Returns the launch's cudaError_t (0 on success).
extern "C" int apm_dp_myers_count(const uint8_t* rows, int64_t n_rows,
                                  int64_t row_stride, const int32_t* peq,
                                  int n_pat, int m_max, int n_chan,
                                  const uint8_t* alph, const int32_t* plens,
                                  int k, int64_t wf, int64_t bound,
                                  const int64_t* dbound, int64_t start,
                                  int32_t* out, int grid, void* stream) {
  const Args a = myers_args(rows, n_rows, row_stride, peq, n_pat, m_max, n_chan, alph, plens, k,
                            wf, bound, dbound, start, out);
  return run(a, grid, stream);
}

// Batch mode: the counts of row block b (rows 8b .. 8b + 7, owned through
// meta[b] = [bound, start]) are added to out[b * out_stride + p]. n_rows
// is a multiple of 8; the caller zeroes out.
extern "C" int apm_dp_myers_batch(const uint8_t* rows, int64_t n_rows,
                                  int64_t row_stride, const int32_t* peq,
                                  int n_pat, int m_max, int n_chan,
                                  const uint8_t* alph, const int32_t* plens,
                                  int k, int64_t wf, const int32_t* meta,
                                  int32_t* out, int64_t out_stride, int grid,
                                  void* stream) {
  if (meta == nullptr || n_rows % apm::kFold != 0 || out_stride < n_pat) {
    return (int)cudaErrorInvalidValue;
  }
  Args a = myers_args(rows, n_rows, row_stride, peq, n_pat, m_max, n_chan, alph, plens, k, wf, 0,
                      nullptr, 0, out);
  a.meta = meta;
  a.out_stride = out_stride;
  return run(a, grid, stream);
}
