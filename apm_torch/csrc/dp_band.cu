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
//
// What bounds it on an H100: integer issue. Each window costs
// m_p * (2k + 1) cells of about seven integer operations per pattern,
// against one byte read from memory, so the kernel is bound by the SMs'
// integer pipes and not by HBM.
//
// Design: the TPU kernel folds windows onto sublanes and rolls a text tile
// one lane per step; Hopper has no lane rotate and gains nothing from it.
// Here each thread owns one window and keeps its 2k+1 band cells in
// registers (templated band width up to kRegMax); the pattern bytes of the
// band sit in a register shift chain, so each step loads one text byte (L1,
// consecutive threads on consecutive bytes) and one pattern byte (the same
// address for the whole block). The band is computed only over
// |d| <= ke = min(k, m_max): D[m][m] depends on cells with 0 <= x, y <= m
// alone, so wider diagonals never reach it, and every k stays exact. Wider
// bands than kRegMax keep their cells in a global scratch buffer (one slab
// per block, cell-major so a warp's accesses coalesce) instead of registers.
// Padding patterns (m_p = 0) are skipped and cost nothing.
#include "scan_common.cuh"

namespace {

using apm::kTile;

// Largest band half-width held in registers.
constexpr int kRegMax = 16;

struct DpArgs {
  const uint8_t* rows;  // (n_rows, row_stride) staged corpus rows
  int64_t n_rows;
  int64_t row_stride;   // wf + halo
  const uint8_t* pat;   // (n_pat, pat_stride) k-padded pattern table
  int n_pat;
  int64_t pat_stride;   // m_max + 2k
  const int32_t* plens; // (n_pat,) pattern lengths, 0 = padding slot
  int k;
  int ke;               // band half-width computed: min(k, m_max)
  int64_t wf;
  int64_t bound;
  int64_t start;
  int32_t* out;         // (n_pat,) counts, accumulated with atomics
  int32_t* scratch;     // wide bands only: (gridDim.x, 2ke + 1, kTile)
};

// Verdict D[m][m] <= k with the band in registers. `txt` points at the
// window's first text byte; `pp` at pattern byte (x - 1 + di) for x = 1,
// di = 0, i.e. pat[p] + (k - KE).
template <int KE>
__device__ __forceinline__ int verdict_reg(const uint8_t* __restrict__ txt,
                                           const uint8_t* __restrict__ pp,
                                           int m, int k) {
  constexpr int BW = 2 * KE + 1;
  const int cap = k + 1;
  int band[BW];
  int pc[BW];
#pragma unroll
  for (int di = 0; di < BW; ++di) {
    band[di] = di >= KE ? di - KE : cap;  // D[0][y] = y; y < 0 out of band
    pc[di] = 0;
  }
#pragma unroll
  for (int di = 0; di + 1 < BW; ++di) pc[di + 1] = pp[di];

  int x = 1;
  // Steps x <= KE can reach the boundary column y = 0 and cells y < 0.
  const int xb = m < KE ? m : KE;
  for (; x <= xb; ++x) {
#pragma unroll
    for (int di = 0; di + 1 < BW; ++di) pc[di] = pc[di + 1];
    pc[BW - 1] = pp[x - 1 + BW - 1];
    const int t = txt[x - 1];
    int prev = cap;
#pragma unroll
    for (int di = 0; di < BW; ++di) {
      const int y = x + di - KE;
      int v = band[di] + (t != pc[di] ? 1 : 0);
      if (di + 1 < BW) v = min(v, band[di + 1] + 1);
      v = min(min(v, prev + 1), cap);
      if (y == 0) v = x;  // x <= KE <= k < cap
      if (y < 0) v = cap;
      band[di] = v;
      prev = v;
    }
  }
  for (; x <= m; ++x) {
#pragma unroll
    for (int di = 0; di + 1 < BW; ++di) pc[di] = pc[di + 1];
    pc[BW - 1] = pp[x - 1 + BW - 1];
    const int t = txt[x - 1];
    int prev = cap;
#pragma unroll
    for (int di = 0; di < BW; ++di) {
      int v = band[di] + (t != pc[di] ? 1 : 0);
      if (di + 1 < BW) v = min(v, band[di + 1] + 1);
      v = min(min(v, prev + 1), cap);
      band[di] = v;
      prev = v;
    }
  }
  return band[KE] <= k ? 1 : 0;
}

// The same verdict for any band width, cells in global scratch: cell di of
// this thread lives at cell[di * kTile].
__device__ int verdict_wide(const uint8_t* __restrict__ txt,
                            const uint8_t* __restrict__ pp, int m, int k,
                            int ke, int32_t* __restrict__ cell) {
  const int bw = 2 * ke + 1;
  const int cap = k + 1;
  for (int di = 0; di < bw; ++di) cell[di * kTile] = di >= ke ? di - ke : cap;
  for (int x = 1; x <= m; ++x) {
    const int t = txt[x - 1];
    int prev = cap;
    int cur = cell[0];
    for (int di = 0; di < bw; ++di) {
      const int y = x + di - ke;
      const int nxt = di + 1 < bw ? cell[(di + 1) * kTile] : cap;
      int v = cur + (t != pp[x - 1 + di] ? 1 : 0);
      v = min(min(v, nxt + 1), min(prev + 1, cap));
      if (y == 0) v = x;
      if (y < 0) v = cap;
      cell[di * kTile] = v;
      prev = v;
      cur = nxt;
    }
  }
  return cell[ke * kTile] <= k ? 1 : 0;
}

// KE >= 0: band in registers with half-width KE; KE < 0: wide band.
template <int KE>
__global__ void __launch_bounds__(kTile) dp_band_kernel(DpArgs a) {
  extern __shared__ int s_cnt[];
  apm::zero_counts(s_cnt, a.n_pat);
  __syncthreads();

  const int64_t tiles_per_row = (a.wf + kTile - 1) / kTile;
  const int64_t n_tiles = a.n_rows * tiles_per_row;
  int32_t* cell = nullptr;
  if (KE < 0) {
    cell = a.scratch + (int64_t)blockIdx.x * (2 * a.ke + 1) * kTile +
           threadIdx.x;
  }
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t r = t / tiles_per_row;
    const int64_t lane0 = (t - r * tiles_per_row) * kTile;
    const int64_t limit =
        apm::owned_limit(r, a.n_rows, a.wf, a.bound, a.start);
    if (lane0 >= limit) continue;  // uniform over the block
    const int64_t lane = lane0 + threadIdx.x;
    const bool own = lane < limit;
    const uint8_t* txt = a.rows + r * a.row_stride + lane;
    for (int p = 0; p < a.n_pat; ++p) {
      const int m = a.plens[p];
      if (m <= 0) continue;  // padding slot: no work
      int hit = 0;
      if (own) {
        const uint8_t* pp = a.pat + (int64_t)p * a.pat_stride + (a.k - a.ke);
        if constexpr (KE >= 0) {
          hit = verdict_reg<KE>(txt, pp, m, a.k);
        } else {
          hit = verdict_wide(txt, pp, m, a.k, a.ke, cell);
        }
      }
      apm::add_hits(s_cnt, p, hit);
    }
  }
  __syncthreads();
  apm::flush_counts(s_cnt, a.out, a.n_pat);
}

template <int KE>
cudaError_t launch(const DpArgs& a, int grid, cudaStream_t stream) {
  dp_band_kernel<KE><<<grid, kTile, a.n_pat * sizeof(int), stream>>>(a);
  return cudaGetLastError();
}

template <int KE>
cudaError_t dispatch(const DpArgs& a, int grid, cudaStream_t stream) {
  if (a.ke == KE) return launch<KE>(a, grid, stream);
  if constexpr (KE < kRegMax) {
    return dispatch<KE + 1>(a, grid, stream);
  } else {
    return launch<-1>(a, grid, stream);
  }
}

}  // namespace

// Adds each pattern's window count to out[p] (the caller zeroes out).
// Returns the launch's cudaError_t (0 on success). Wide bands
// (ke > kRegMax) need `scratch` with room for grid * (2ke + 1) * 256 int32.
extern "C" int apm_dp_band_count(const uint8_t* rows, int64_t n_rows,
                                 int64_t row_stride, const uint8_t* pat,
                                 int n_pat, int64_t pat_stride,
                                 const int32_t* plens, int k, int ke,
                                 int64_t wf, int64_t bound, int64_t start,
                                 int32_t* out, int32_t* scratch, int grid,
                                 void* stream) {
  DpArgs a{rows, n_rows, row_stride, pat, n_pat, pat_stride, plens, k, ke,
           wf,   bound,  start,      out, scratch};
  if (grid <= 0 || n_pat <= 0 || ke < 0 || ke > k) {
    return (int)cudaErrorInvalidValue;
  }
  if (ke > kRegMax && scratch == nullptr) return (int)cudaErrorInvalidValue;
  return (int)dispatch<0>(a, grid, (cudaStream_t)stream);
}

extern "C" int apm_dp_band_reg_max() { return kRegMax; }
