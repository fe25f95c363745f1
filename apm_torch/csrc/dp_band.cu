// Banded Levenshtein window count (kernel A).
//
// Replaces apm/ops/pallas_kernel.py::_scan_folded_pallas_unrolled in band
// mode (kernel body _scan_kernel_unrolled -> _band_phases). Same contract:
// staged rows (R, wf + halo) uint8, the k-padded pattern table
// (P, m_max + 2k) uint8 and per-pattern lengths; window j = start + r*wf +
// lane (lane < wf) counts for pattern p iff j < bound and the banded
// distance D[m_p][m_p] <= k. The recurrence is apm/utils/oracle.py's
// banded_distances: band[k + d] = D[x][x + d], text byte of step x is
// rows[r, lane + x - 1], pattern byte pat[p, x - 1 + d + k], first row
// D[0][y] = y, boundary D[x][0] = x, cells clamped at k + 1 (clamping
// commutes with the min-plus recurrence, so the <= k verdict is exact).
// The band is computed only over |d| <= ke = min(k, m_max): D[m][m]
// depends on cells with 0 <= x, y <= m alone, so wider diagonals never
// reach it, and every k stays exact. Padding patterns (m_p = 0) cost
// nothing.
//
// What bounds it on an H100: integer issue. Each window costs m_p * (2k + 1)
// min-plus cells per pattern against one byte read from memory.
//
// Design: dp_pair.cuh's tile walk and paired 16-bit DPX band, shared with
// the mask kernel #6 (dp_mask.cu): two windows a thread, four DPX-form
// instructions a cell for the pair; each 512-window tile's text is staged
// once by cp.async, a tile ahead, and every pattern is scanned from it;
// the pattern table lives in shared memory as byte * 0x10001 words (read
// from global memory when it passes 32 KB). A thread adds 0, 1 or 2 hits
// a pattern to the block's shared counters. k + 1 >= kCapMax (cells past
// 16 bits) counts at k' = kCapMax - 2 on the register path: there
// ke = m_max <= 16 < k', and D[m][m] <= m, so both verdicts are "yes".
//
// The batch mode (apm_dp_band_batch, _scan_folded_pallas_batch, TPU kernel
// #4) shares the kernel body: many corpora in one launch, one [bound,
// start] pair per block of 8 staged rows (apm::batch_limit) and an (R/8, P)
// count output. The TPU gives each grid step its own output slot; here a
// block's tiles belong to different row blocks (tiles never cross a row),
// so it flushes its shared counters into the tile's slot after every tile
// (one atomic per nonzero slot and pattern).
//
// Another C entry (apm_dp_band_dyn) replaces apm/ops/pallas_kernel.py::
// scan_folded_pallas (kernel body _scan_kernel, TPU kernel #9), the band
// with dynamic lengths: the count mode with the lengths, and optionally
// the bound and start, read from device memory, so the host never learns
// them. The step loop of each pattern still ends at its own length; the
// TPU kernel runs every pattern for all of m_max steps and captures
// D[m][m] at step m, which is the same verdict. A length outside
// [1, m_max] counts nothing in every mode, as the TPU kernel's capture
// never fires for it.
#include "dp_pair.cuh"

using namespace apm::pair;

namespace {

// KE >= 0: band pair in registers with half-width KE; KE < 0: wide band.
// STAGED: text and pattern table in shared memory; else read from global.
template <int KE, bool STAGED>
__global__ void __launch_bounds__(kThreads, band_blocks(KE)) dp_band_kernel(Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  int* s_cnt = reinterpret_cast<int*>(smem);  // (n_pat,)
  int* s_plen = s_cnt + a.n_pat;              // (n_pat,)
  uint32_t* s_pat = smem + 2 * a.n_pat;       // STAGED: (n_pat * pat_stride,) byte * 0x10001
  uint32_t* s_txt = s_pat + a.n_pat * a.pat_stride;  // STAGED: two buffers of stage_words

  for (int i = threadIdx.x; i < a.n_pat; i += blockDim.x) {
    s_cnt[i] = 0;
    s_plen[i] = a.plens[i];
  }
  if constexpr (STAGED) {
    const int n_words = a.n_pat * (int)a.pat_stride;
    for (int i = threadIdx.x; i < n_words; i += blockDim.x) s_pat[i] = a.pat[i] * kOne2;
  }

  // Phase-2 verification passes its bound (and #9 its start) in device
  // memory.
  const int64_t bound = a.dbound != nullptr ? *a.dbound : a.bound;
  const int64_t start = a.dstart != nullptr ? *a.dstart : a.start;
  const int kv = KE >= 0 ? min(a.k, kCapMax - 2) : a.k;  // the verdict's k (see above)
  const int64_t tpr = tiles_per_row(a);
  const int64_t n_tiles = a.n_rows * tpr;
  // Tile t is scanned iff its first lane is owned.
  auto needed = [&](int64_t t) {
    const int64_t r = t / tpr;
    return (t - r * tpr) * kWin < row_limit(a, r, bound, start);
  };
  int32_t* cell = nullptr;
  if (KE < 0) cell = a.scratch + (int64_t)blockIdx.x * (2 * a.ke + 1) * kThreads + threadIdx.x;

  int buf = 0;
  if constexpr (STAGED) {
    if (needed(blockIdx.x)) stage_text(a, blockIdx.x, s_txt);
    cp_async_commit();
  } else {
    __syncthreads();  // s_plen
  }
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    if constexpr (STAGED) {
      const int64_t tn = t + gridDim.x;
      if (tn < n_tiles && needed(tn)) stage_text(a, tn, s_txt + (buf ^ 1) * a.stage_words);
      cp_async_commit();
      cp_async_wait_prev();  // this thread's copies of tile t have landed
      __syncthreads();       // and every thread's
    }

    const int64_t r = t / tpr;
    const int64_t lane0 = (t - r * tpr) * kWin;
    const int64_t limit = row_limit(a, r, bound, start);
    if (lane0 < limit) {  // uniform over the block
      const int64_t lane = lane0 + 2 * threadIdx.x;
      const int own = (lane < limit ? 1 : 0) | (lane + 1 < limit ? 2 : 0);
      for (int p = 0; p < a.n_pat; ++p) {
        const int m = s_plen[p];
        if (m <= 0 || m > a.m_max) continue;  // uniform: a padding slot
        int hits = 0;
        if (own != 0) {
          const int64_t p0 = (int64_t)p * a.pat_stride + (a.k - a.ke);
          if constexpr (STAGED) {
            const SharedSrc s{
                reinterpret_cast<const uint8_t*>(s_txt + buf * a.stage_words) + 2 * threadIdx.x,
                s_pat + p0};
            hits = band_hits<KE>(s, a, kv, m, own, cell);
          } else {
            const GlobalSrc s{a.rows + r * a.row_stride + lane, a.pat + p0, a.row_stride - lane};
            hits = band_hits<KE>(s, a, kv, m, own, cell);
          }
        }
        apm::add_hits(s_cnt, p, (hits & 1) + (hits >> 1));
      }
    }
    // STAGED: every thread is done with this buffer; batch: with the counters.
    if (STAGED || a.meta != nullptr) __syncthreads();
    if (a.meta != nullptr) {
      apm::flush_and_reset(s_cnt, a.out + (r / apm::kFold) * a.out_stride, a.n_pat);
      if (!STAGED) __syncthreads();  // STAGED: the next tile's barrier
    }
    buf ^= 1;
  }
  if constexpr (STAGED) cp_async_wait_all();
  if (a.meta == nullptr) {
    __syncthreads();
    apm::flush_counts(s_cnt, a.out, a.n_pat);
  }
}

template <int KE, bool STAGED>
cudaError_t launch(const Args& a, int cap, cudaStream_t stream) {
  size_t smem = sizeof(int) * 2 * (size_t)a.n_pat;
  if (STAGED) {
    smem += sizeof(uint32_t) * ((size_t)a.n_pat * a.pat_stride + 2 * (size_t)a.stage_words);
  }
  int grid = 0;
  cudaError_t e = pair_grid(n_tiles(a), band_blocks(KE), cap, &grid);
  if (e == cudaSuccess) e = allow_smem(dp_band_kernel<KE, STAGED>, smem);
  if (e != cudaSuccess) return e;
  dp_band_kernel<KE, STAGED><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int KE, bool STAGED>
cudaError_t dispatch(const Args& a, int cap, cudaStream_t stream) {
  if (a.ke == KE) return launch<KE, STAGED>(a, cap, stream);
  if constexpr (KE < kRegMax) {
    return dispatch<KE + 1, STAGED>(a, cap, stream);
  } else {
    return launch<-1, STAGED>(a, cap, stream);
  }
}

Args band_args(const uint8_t* rows, int64_t n_rows, int64_t row_stride, const uint8_t* pat,
               int n_pat, int64_t pat_stride, const int32_t* plens, int k, int ke, int64_t wf,
               int64_t bound, const int64_t* dbound, int64_t start, int32_t* out,
               int32_t* scratch) {
  Args a = base_args(rows, n_rows, row_stride, n_pat, (int)(pat_stride - 2 * (int64_t)k), plens,
                     k, wf, bound, dbound, start, out);
  a.pat = pat;
  a.pat_stride = pat_stride;
  a.ke = ke;
  a.scratch = scratch;
  return a;
}

int run(const Args& a, int grid, void* stream) {
  if (a.n_rows <= 0 || a.n_pat <= 0 || a.wf <= 0 || a.m_max <= 0 || a.k < 0 ||
      a.ke != std::min(a.k, a.m_max) || a.row_stride < a.wf + a.m_max - 1 ||
      (a.ke > kRegMax && (a.scratch == nullptr || grid <= 0))) {
    return (int)cudaErrorInvalidValue;
  }
  const bool staged = 4 * (int64_t)a.n_pat * a.pat_stride <= kTableBytes;
  return (int)(staged ? dispatch<0, true>(a, grid, (cudaStream_t)stream)
                      : dispatch<0, false>(a, grid, (cudaStream_t)stream));
}

}  // namespace

// Adds each pattern's window count to out[p] (the caller zeroes out).
// `dbound`, when not null, points at an int64 window bound in device memory
// that replaces `bound`. One launch: its grid is sized here (blocks_per_sm
// a SM); a positive `grid` caps it. Wide bands (ke > kRegMax) need a
// positive `grid` and `scratch` with room for grid * (2ke + 1) * 256 int32.
// A table of n_pat * pat_stride 4-byte words within 32 KB is staged in
// shared memory, a larger one read from global memory (the caller groups
// patterns to stay within it). Returns the launch's cudaError_t (0 on
// success).
extern "C" int apm_dp_band_count(const uint8_t* rows, int64_t n_rows,
                                 int64_t row_stride, const uint8_t* pat,
                                 int n_pat, int64_t pat_stride,
                                 const int32_t* plens, int k, int ke,
                                 int64_t wf, int64_t bound,
                                 const int64_t* dbound, int64_t start,
                                 int32_t* out, int32_t* scratch, int grid,
                                 void* stream) {
  const Args a = band_args(rows, n_rows, row_stride, pat, n_pat, pat_stride, plens, k, ke, wf,
                           bound, dbound, start, out, scratch);
  return run(a, grid, stream);
}

// Batch mode: adds the counts of row block b (rows 8b .. 8b + 7, owned
// through meta[b] = [bound, start]) to out[b * out_stride + p]. n_rows is a
// multiple of 8; the caller zeroes out.
extern "C" int apm_dp_band_batch(const uint8_t* rows, int64_t n_rows,
                                 int64_t row_stride, const uint8_t* pat,
                                 int n_pat, int64_t pat_stride,
                                 const int32_t* plens, int k, int ke,
                                 int64_t wf, const int32_t* meta,
                                 int32_t* out, int64_t out_stride,
                                 int32_t* scratch, int grid, void* stream) {
  if (meta == nullptr || n_rows % apm::kFold != 0 || out_stride < n_pat) {
    return (int)cudaErrorInvalidValue;
  }
  Args a = band_args(rows, n_rows, row_stride, pat, n_pat, pat_stride, plens, k, ke, wf, 0,
                     nullptr, 0, out, scratch);
  a.meta = meta;
  a.out_stride = out_stride;
  return run(a, grid, stream);
}

// Dynamic lengths (the TPU's scan_folded_pallas): apm_dp_band_count with
// `plens` in device memory, filled by the caller without the host reading
// it, and `dstart`, when not null, an int64 window start in device memory
// that replaces `start` (`dbound` likewise replaces `bound`). ke is
// min(k, m_max) with m_max = pat_stride - 2k.
extern "C" int apm_dp_band_dyn(const uint8_t* rows, int64_t n_rows,
                               int64_t row_stride, const uint8_t* pat,
                               int n_pat, int64_t pat_stride,
                               const int32_t* plens, int k, int ke, int64_t wf,
                               int64_t bound, const int64_t* dbound,
                               int64_t start, const int64_t* dstart,
                               int32_t* out, int32_t* scratch, int grid,
                               void* stream) {
  if (plens == nullptr) return (int)cudaErrorInvalidValue;
  Args a = band_args(rows, n_rows, row_stride, pat, n_pat, pat_stride, plens, k, ke, wf, bound,
                     dbound, start, out, scratch);
  a.dstart = dstart;
  return run(a, grid, stream);
}

extern "C" int apm_dp_band_reg_max() { return kRegMax; }
