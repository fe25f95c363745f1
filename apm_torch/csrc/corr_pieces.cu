// Exact piece scan, filtration phase 1 under corr_impl="fused" (kernel #7).
//
// Replaces apm/ops/corr_fused.py::scan_pieces_fused (kernel body
// _fused_pieces_kernel). Same contract: staged rows (R, wf + halo) uint8,
// the global window bound and start, n_rows, and the exact-tier pieces of
// every pattern (bytes, length, owning pattern), decoded on the host from
// the TPU's tables (km, thr, owner64). A staged row r is live iff
// r < n_rows and start + r*wf < bound. For each live row, each piece q and
// each position j in [0, wf + 64), the piece hits when the l_q text bytes
// at j equal its bytes. rowpat[r, p] is the number of hits of p's pieces in
// row r; the outputs are fcnt[p] = sum over rows of rowpat[r, p] and
// rowmap[r, p] = (rowpat[r, p] > 0), both int32.
//
// The position bound wf + 64 is the TPU kernel's coverage bound (its two
// 64-window phases per 128-byte chunk, masked by j < wf + 64), not the
// ownership limit; it is copied so that the row maps agree cell for cell.
// Every read stays inside the row: j + l - 1 <= wf + 63 + 64 < wf + halo
// (the wrapper checks halo >= 63 + l_max). The ±1 bit-plane matmul of the
// TPU is its way to test byte equality (a byte outside the alphabet encodes
// to zero planes and never reaches the threshold; piece bytes are alphabet
// bytes), so a byte compare with early exit is the same function.
//
// What bounds it on an H100: instruction issue. On random DNA text a
// piece's compare chain stops after one or two bytes, so a position costs a
// few shared-memory loads and compares per piece, plus the piece loop and
// one warp reduction per piece (~25 SASS instructions per piece and
// position besides the compares); the staged rows are read once (HBM). At
// 3 instructions per compare it reaches ~3 % of that bound: the per-piece
// overhead, not the compares, is where a faster design has to cut.
//
// Design: the TPU's phase split, its roll of the text by 64 lanes and the
// owner64 matmul feed the MXU and have no use here. A block walks tiles of
// 256 positions of one row, grid-stride, one position per thread; it
// stages the tile's text (256 + l_max - 1 bytes) and, once per launch, the
// pieces (bytes, lengths, owners) in shared memory. Hits are reduced per
// warp and counted per pattern in shared memory; after each tile a nonzero
// counter sets rowmap[r, p] = 1 (a plain store: every writer stores the
// same value) and adds to the block's totals, which reach fcnt with one
// atomic per nonzero (block, pattern). Non-live rows are skipped whole.
// Pieces and patterns come in launch groups (piece0, pat0) sized by the
// wrapper so that shared memory holds them.
#include "scan_common.cuh"

namespace {

using apm::kTile;

// Positions past wf that the TPU kernel's second phase covers.
constexpr int kReach = 64;

struct PieceArgs {
  const uint8_t* rows;   // (n_staged, row_stride) staged corpus rows
  int64_t n_staged;
  int64_t row_stride;    // wf + halo
  int64_t n_rows;        // rows carrying real windows
  const uint8_t* piece;  // (n_piece, piece_stride) piece bytes
  int n_piece;
  int piece_stride;      // l_max of this group
  const int32_t* plen;   // (n_piece,) piece lengths, <= 0 = padding slot
  const int32_t* owner;  // (n_piece,) owning pattern, in [pat0, pat0+n_pat)
  int pat0;
  int n_pat;
  int64_t wf;
  int64_t bound;
  int64_t start;
  int32_t* fcnt;         // fcnt + pat0: (n_pat,) totals, accumulated
  int32_t* rowmap;       // rowmap + pat0: row r at rowmap + r*rowmap_stride
  int64_t rowmap_stride;
};

__global__ void __launch_bounds__(kTile) pieces_fused_kernel(PieceArgs a) {
  extern __shared__ int smem[];
  int* s_tot = smem;                 // (n_pat,) block totals
  int* s_tile = smem + a.n_pat;      // (n_pat,) this tile's hits
  int* s_plen = smem + 2 * a.n_pat;  // (n_piece,)
  int* s_own = s_plen + a.n_piece;   // (n_piece,) local pattern index
  uint8_t* s_piece = reinterpret_cast<uint8_t*>(s_own + a.n_piece);
  uint8_t* s_txt = s_piece + (int64_t)a.n_piece * a.piece_stride;

  for (int i = threadIdx.x; i < 2 * a.n_pat; i += blockDim.x) smem[i] = 0;
  for (int i = threadIdx.x; i < a.n_piece; i += blockDim.x) {
    s_plen[i] = a.plen[i];
    s_own[i] = a.owner[i] - a.pat0;
  }
  for (int i = threadIdx.x; i < a.n_piece * a.piece_stride; i += blockDim.x) {
    s_piece[i] = a.piece[i];
  }
  __syncthreads();

  const int64_t span = a.wf + kReach;  // positions per row
  const int64_t tiles_per_row = (span + kTile - 1) / kTile;
  const int64_t rows = a.n_rows < a.n_staged ? a.n_rows : a.n_staged;
  const int64_t n_tiles = rows * tiles_per_row;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t r = t / tiles_per_row;
    if (a.start + r * a.wf >= a.bound) continue;  // not live: uniform
    const int64_t j0 = (t - r * tiles_per_row) * kTile;

    const uint8_t* row = a.rows + r * a.row_stride + j0;
    const int64_t rest = a.row_stride - j0;
    const int64_t want = kTile + a.piece_stride - 1;
    const int n_txt = (int)(want < rest ? want : rest);
    for (int i = threadIdx.x; i < n_txt; i += blockDim.x) s_txt[i] = row[i];
    __syncthreads();

    const bool active = j0 + threadIdx.x < span;
    const uint8_t* txt = s_txt + threadIdx.x;
    for (int q = 0; q < a.n_piece; ++q) {
      const int l = s_plen[q];
      if (l <= 0) continue;  // padding slot: uniform over the block
      int hit = 0;
      if (active) {
        const uint8_t* pc = s_piece + (int64_t)q * a.piece_stride;
        int i = 0;
        while (i < l && txt[i] == pc[i]) ++i;
        hit = i == l ? 1 : 0;
      }
      apm::add_hits(s_tile, s_own[q], hit);
    }
    __syncthreads();
    for (int p = threadIdx.x; p < a.n_pat; p += blockDim.x) {
      const int v = s_tile[p];
      if (v != 0) {
        a.rowmap[r * a.rowmap_stride + p] = 1;
        s_tot[p] += v;
        s_tile[p] = 0;
      }
    }
    __syncthreads();  // counters reset and staged text free again
  }
  apm::flush_counts(s_tot, a.fcnt, a.n_pat);
}

}  // namespace

// Adds piece-hit totals to fcnt[pat0 + p] and sets rowmap[r * rowmap_stride
// + pat0 + p] = 1 where row r holds a hit of pattern pat0 + p (the caller
// zeroes both). Returns the launch's cudaError_t (0 on success).
extern "C" int apm_pieces_fused_count(
    const uint8_t* rows, int64_t n_staged, int64_t row_stride, int64_t n_rows,
    const uint8_t* piece, int n_piece, int piece_stride, const int32_t* plen,
    const int32_t* owner, int pat0, int n_pat, int64_t wf, int64_t bound,
    int64_t start, int32_t* fcnt, int32_t* rowmap, int64_t rowmap_stride,
    int grid, void* stream) {
  if (grid <= 0 || n_piece <= 0 || n_pat <= 0 || piece_stride <= 0 ||
      row_stride < wf + kReach + piece_stride - 1) {
    return (int)cudaErrorInvalidValue;
  }
  const PieceArgs a{rows,  n_staged, row_stride, n_rows, piece,
                    n_piece, piece_stride, plen, owner, pat0,
                    n_pat, wf,       bound,      start,  fcnt + pat0,
                    rowmap + pat0, rowmap_stride};
  const size_t smem = sizeof(int) * (2 * (size_t)n_pat + 2 * (size_t)n_piece) +
                      (size_t)n_piece * piece_stride + kTile + piece_stride;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pieces_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pieces_fused_kernel<<<grid, kTile, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
