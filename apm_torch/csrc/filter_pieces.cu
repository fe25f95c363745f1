// Pigeonhole piece filter, phase 1 of filtration (kernel D).
//
// Replaces apm/ops/filter_kernel.py::scan_filter_pallas (kernel body
// _filter_kernel). Same contract: staged rows (R, wf + halo) uint8 with
// halo >= m_max + 2k, the pattern byte table widened to int32 and padded
// with `pad` sentinel columns (value 256) in front when a banded-tier
// pattern is present, and the static piece plan of every pattern: pieces
// (o, li, kp) with their occurrence-shift range [s_lo, s_hi]
// (filter_kernel.piece_shift_range). Window j = start + r*wf + lane is a
// candidate of pattern p iff j < bound and some piece q hits at text
// position lane + o_q + s for some s in q's range. A piece hits at T when
// its pinned-start band (2kp + 1 cells, D[0][d] = d, out-of-band cells
// INF) reaches a value <= kp at one of its end drifts d in [-kp, kp] (cell
// d after li - d steps). kp = 0 (exact tier) is a byte compare of the
// piece. Outputs, both int32 and equal cell for cell to the TPU kernel's:
// fcnt (P,) candidate totals (exact match counts at k = 0) and rowmap
// (R, P), the number of candidate windows of each row.
//
// What bounds it on an H100: on random text a piece's compare chain or
// band stops after one or two bytes (a mismatch, or every band cell past
// kp), so the kernel costs a few shared-memory reads and integer
// operations per piece and position; the staged rows are read once.
//
// Design: the TPU kernel rolls two text tiles one lane per step, carries
// every live piece's band as (fold, wf + 2k) tiles, and ORs shifted
// slices of each piece's hit tile. Here a block takes tiles of 256 windows
// of one row and stages the tile's text (256 + halo bytes) in shared
// memory. For each piece the block computes the hit bit of every position
// the tile's windows can reach (256 + span positions, span = s_hi - s_lo),
// once, into shared memory; each thread then ORs its window's span + 1
// hits. Every piece's chain or band exits as soon as it cannot hit, which
// the TPU's lockstep tiles cannot do. Candidate windows are counted per
// pattern in shared memory and added to rowmap and fcnt with one atomic
// per nonzero (tile, pattern) and (block, pattern): rows without
// candidates cost no global atomics.
#include "scan_common.cuh"

namespace {

using apm::kTile;

constexpr int kInf = 1 << 20;  // additive-safe INF of out-of-band cells

struct FilterArgs {
  const uint8_t* rows;  // (n_rows, row_stride) staged corpus rows
  int64_t n_rows;
  int64_t row_stride;   // wf + halo
  const int32_t* pchar; // (n_pat, pchar_stride) sentinel-padded bytes
  int n_pat;
  int64_t pchar_stride;
  int pad;              // front sentinel columns (max kp)
  const int32_t* pieces;  // (n_pieces, 5): o, li, kp, s_lo, s_hi
  const int32_t* pstart;  // (n_pat + 1,) piece range of each pattern
  int span_max;         // max s_hi - s_lo over the pieces
  int64_t wf;
  int64_t bound;
  int64_t start;
  int32_t* fcnt;        // (n_pat,) candidate totals, accumulated
  int32_t* rowmap;      // (n_rows, rowmap_stride) per-row candidates
  int64_t rowmap_stride;
};

// Exact tier: the piece's li bytes equal the text at `txt`.
__device__ __forceinline__ int hit_exact(const uint8_t* txt,
                                         const int32_t* __restrict__ pc,
                                         int li) {
  for (int t = 0; t < li; ++t) {
    if ((int)txt[t] != pc[t]) return 0;
  }
  return 1;
}

// Banded tier (kp = 1): pinned-start width-3 band; `pc` points at the
// piece's first byte in the sentinel-padded table (pc[-1] is readable).
// Cell di = d + 1 after t steps holds D[t + d][t]; the verdict is the
// minimum of cell d after li - d steps, d in [-1, 1], against 1.
__device__ __forceinline__ int hit_banded(const uint8_t* txt,
                                          const int32_t* __restrict__ pc,
                                          int li) {
  int b0 = kInf, b1 = 0, b2 = 1;
  int cap = kInf;
  for (int t = 1; t <= li + 1; ++t) {
    const int x = txt[t - 1];
    const int n0 = min(b0 + (x != pc[t - 2] ? 1 : 0), b1 + 1);
    const int n1 = min(min(b1 + (x != pc[t - 1] ? 1 : 0), b2 + 1), n0 + 1);
    const int n2 = min(b2 + (x != pc[t] ? 1 : 0), n1 + 1);
    b0 = n0;
    b1 = n1;
    b2 = n2;
    if (t == li - 1) {
      cap = b2;
    } else if (t == li) {
      cap = min(cap, b1);
    } else if (t == li + 1) {
      cap = min(cap, b0);
    }
    // Band minima never decrease: past kp everywhere, no later capture
    // can reach kp.
    if (min(b0, min(b1, b2)) > 1) break;
  }
  return cap <= 1 ? 1 : 0;
}

__global__ void __launch_bounds__(kTile) filter_pieces_kernel(FilterArgs a) {
  extern __shared__ int smem[];
  int* s_cnt = smem;              // (n_pat,) block totals
  int* s_tile = smem + a.n_pat;   // (n_pat,) this tile's counts
  uint8_t* s_hit = reinterpret_cast<uint8_t*>(smem + 2 * a.n_pat);
  uint8_t* s_txt = s_hit + kTile + a.span_max;  // tile text + halo

  for (int i = threadIdx.x; i < 2 * a.n_pat; i += blockDim.x) smem[i] = 0;
  __syncthreads();

  const int64_t halo = a.row_stride - a.wf;
  const int64_t tiles_per_row = (a.wf + kTile - 1) / kTile;
  const int64_t n_tiles = a.n_rows * tiles_per_row;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t r = t / tiles_per_row;
    const int64_t lane0 = (t - r * tiles_per_row) * kTile;
    const int64_t limit = apm::owned_limit(r, a.n_rows, a.wf, a.bound, a.start);
    if (lane0 >= limit) continue;  // uniform over the block
    const int lim = limit - lane0 < kTile ? (int)(limit - lane0) : kTile;
    const bool own = (int)threadIdx.x < lim;

    // Stage the tile's text; no read reaches past it (halo >= m + 2k).
    const uint8_t* row = a.rows + r * a.row_stride + lane0;
    const int64_t rest = a.row_stride - lane0;
    const int n_txt = (int)(kTile + halo < rest ? kTile + halo : rest);
    for (int i = threadIdx.x; i < n_txt; i += blockDim.x) s_txt[i] = row[i];
    __syncthreads();

    for (int p = 0; p < a.n_pat; ++p) {
      const int q0 = a.pstart[p], q1 = a.pstart[p + 1];
      if (q0 == q1) continue;  // padding slot: no work
      const int32_t* pc_p = a.pchar + (int64_t)p * a.pchar_stride + a.pad;
      int cand = 0;
      for (int q = q0; q < q1; ++q) {
        const int32_t* pq = a.pieces + 5 * q;
        const int o = pq[0], li = pq[1], kp = pq[2], s_lo = pq[3];
        const int span = pq[4] - s_lo;
        __syncthreads();  // the previous piece's hits are read
        for (int i = threadIdx.x; i < kTile + span; i += blockDim.x) {
          int h = 0;
          // Position i serves windows i - span .. i of the tile; compute
          // it only when one of them is owned.
          if (i - span < lim) {
            const uint8_t* txt = s_txt + o + s_lo + i;
            h = kp == 0 ? hit_exact(txt, pc_p + o, li)
                        : hit_banded(txt, pc_p + o, li);
          }
          s_hit[i] = (uint8_t)h;
        }
        __syncthreads();
        if (own) {
          for (int s = 0; s <= span; ++s) cand |= s_hit[threadIdx.x + s];
        }
      }
      apm::add_hits(s_tile, p, own ? cand : 0);
    }
    __syncthreads();
    for (int i = threadIdx.x; i < a.n_pat; i += blockDim.x) {
      const int v = s_tile[i];
      if (v != 0) {
        atomicAdd(&a.rowmap[r * a.rowmap_stride + i], v);
        s_cnt[i] += v;
        s_tile[i] = 0;
      }
    }
    __syncthreads();  // counters reset and staged text free again
  }
  apm::flush_counts(s_cnt, a.fcnt, a.n_pat);
}

}  // namespace

// Adds candidate counts to fcnt[p] and rowmap[r * rowmap_stride + p] (the
// caller zeroes both). Returns the launch's cudaError_t (0 on success).
extern "C" int apm_filter_pieces_count(
    const uint8_t* rows, int64_t n_rows, int64_t row_stride,
    const int32_t* pchar, int n_pat, int64_t pchar_stride, int pad,
    const int32_t* pieces, const int32_t* pstart, int span_max, int64_t wf,
    int64_t bound, int64_t start, int32_t* fcnt, int32_t* rowmap,
    int64_t rowmap_stride, int grid, void* stream) {
  if (grid <= 0 || n_pat <= 0 || pad < 0 || pad > 1 || span_max < 0 ||
      row_stride <= wf) {
    return (int)cudaErrorInvalidValue;
  }
  FilterArgs a{rows,   n_rows,   row_stride, pchar, n_pat,  pchar_stride,
               pad,    pieces,   pstart,     span_max, wf,  bound,
               start,  fcnt,     rowmap,     rowmap_stride};
  const size_t smem = sizeof(int) * 2 * (size_t)n_pat + kTile + span_max +
                      kTile + (size_t)(row_stride - wf);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        filter_pieces_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  filter_pieces_kernel<<<grid, kTile, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
