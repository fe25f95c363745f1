// Exact piece scan, filtration phase 1 under corr_impl="fused" (kernel #7).
//
// Replaces apm/ops/corr_fused.py::scan_pieces_fused (kernel body
// _fused_pieces_kernel). Same contract: staged rows (R, wf + halo) uint8,
// the global window bound and start, n_rows, and the exact-tier pieces of
// every pattern (bytes, length, owning pattern, 8-byte prefix word and
// mask), decoded on the host from the TPU's tables (km, thr, owner64). A
// staged row r is live iff r < n_rows and start + r*wf < bound. For each
// live row, each piece q and each position j in [0, wf + 64), the piece
// hits when the l_q text bytes at j equal its bytes. rowpat[r, p] is the
// number of hits of p's pieces in row r; the outputs are fcnt[p] = sum
// over rows of rowpat[r, p] and rowmap[r, p] = (rowpat[r, p] > 0), both
// int32.
//
// The position bound wf + 64 is the TPU kernel's coverage bound (its two
// 64-window phases per 128-byte chunk, masked by j < wf + 64), not the
// ownership limit; it is copied so that the row maps agree cell for cell.
// Every read stays inside the row: j + l - 1 <= wf + 63 + 64 < wf + halo
// (the wrapper checks halo >= 63 + l_max). The ±1 bit-plane matmul of the
// TPU is its way to test byte equality (a byte outside the alphabet encodes
// to zero planes and never reaches the threshold; piece bytes are alphabet
// bytes), so a byte compare is the same function.
//
// What bounds it on an H100: instruction issue, every position tested
// against every piece; the staged rows are read once (HBM). The
// instructions around each test count as much as the test: a design of
// one thread per position with a byte compare chain and one warp
// reduction per piece and position (~25 SASS instructions per piece and
// position besides the compares) reached 3.2 % of the bound.
//
// Design (exact_scan.cuh, shared with kernel B's count mode): a block
// takes one staged row per item, 9 warps of 32 positions per thread
// covering its wf + 64 positions at wf = 8192; each thread reads its text
// with two 16-byte loads (the next row's loads in flight during this row's
// compares) and tests each position's 8-byte prefix, built in registers,
// against each piece's prefix word in three instructions. Exact-tier
// pieces are at least 8 bytes at every k (filter_kernel.tier_of), so only
// a prefix match reads the piece's remaining bytes. A thread sums a
// piece's hits over its 32 positions in a register and adds the sum to the
// row's shared counter of the piece's pattern only when nonzero. After the
// row a nonzero counter sets rowmap[r, p] = 1 (a plain store: every writer
// stores the same value) and adds to the block's totals, which reach fcnt
// with one atomic per nonzero (block, pattern); the row counters come in
// two halves, by row parity, so a row costs one barrier. Non-live rows
// load and test nothing. Pieces and patterns come in launch groups
// (piece0, pat0) sized by the wrapper so that shared memory holds them.
#include "exact_scan.cuh"
#include "scan_common.cuh"

namespace {

namespace ex = apm::exact;

// Positions past wf that the TPU kernel's second phase covers.
constexpr int kReach = 64;

struct PieceArgs {
  const uint8_t* rows;   // (n_staged, row_stride) staged corpus rows
  int64_t n_staged;
  int64_t row_stride;    // wf + halo, a multiple of 16
  int64_t n_rows;        // rows carrying real windows
  const uint8_t* piece;  // (n_piece, piece_stride) piece bytes
  int n_piece;
  int piece_stride;      // l_max of the tables
  const int32_t* plen;   // (n_piece,) piece lengths, <= 0 = padding slot
  const int32_t* owner;  // (n_piece,) owning pattern, in [pat0, pat0+n_pat)
  const uint4* prefix;   // (n_piece,) prefix word lo, hi, mask lo, hi
  int pat0;
  int n_pat;
  int64_t wf;
  int64_t bound;
  int64_t start;
  int32_t* fcnt;         // fcnt + pat0: (n_pat,) totals, accumulated
  int32_t* rowmap;       // rowmap + pat0: row r at rowmap + r*rowmap_stride
  int64_t rowmap_stride;
};

// 2 blocks an SM (ops/corr_fused.py's _EXACT_BLOCKS_PER_SM sizes the grid
// to match; 3 an SM read no faster).
__global__ void __launch_bounds__(ex::kMaxThreads, 2)
    pieces_fused_kernel(PieceArgs a) {
  extern __shared__ uint4 smem4[];
  uint4* s_pre = smem4;                                        // (n_piece,)
  int* s_len = reinterpret_cast<int*>(s_pre + a.n_piece);      // (n_piece,)
  int* s_own = s_len + a.n_piece;    // (n_piece,) local pattern index
  int* s_tot = s_own + a.n_piece;    // (n_pat,) block totals
  // (2, n_pat) a row's hits, by the parity of the block's item: a row
  // counts into one half while the other half, the previous row's, is
  // flushed, so one barrier per row suffices
  int* s_rows = s_tot + a.n_pat;
  for (int i = threadIdx.x; i < a.n_piece; i += blockDim.x) {
    s_pre[i] = a.prefix[i];
    s_len[i] = a.plen[i];
    s_own[i] = a.owner[i] - a.pat0;
  }
  for (int i = threadIdx.x; i < 3 * a.n_pat; i += blockDim.x) s_tot[i] = 0;
  __syncthreads();
  int half = 0;  // the half this row counts into

  const int64_t rows = a.n_rows < a.n_staged ? a.n_rows : a.n_staged;
  const int64_t span = a.wf + kReach;  // positions per row
  auto live = [=](int64_t r) -> int64_t {
    return a.start + r * a.wf < a.bound ? span : 0;
  };
  auto slots = [=, &half](const ex::Chunk& ch, const uint32_t (&v)[ex::kW + 4],
                          uint32_t own) {
    int* s_row = s_rows + half * a.n_pat;
    const uint8_t* txt = a.rows + ch.r * a.row_stride + ch.j0;
    for (int q = 0; q < a.n_piece; ++q) {
      const int l = s_len[q];
      if (l <= 0) continue;  // padding slot: uniform over the block
      const uint32_t bits = ex::match_bits(v, s_pre[q]) & own;
      if (bits != 0) {
        const int c = ex::count_tails(
            bits, txt, a.piece + (int64_t)q * a.piece_stride, l);
        if (c != 0) atomicAdd(&s_row[s_own[q]], c);
      }
    }
  };
  auto after = [=, &half](int64_t r) {
    __syncthreads();  // this row's counts are in; the other half is zero
    int* s_row = s_rows + half * a.n_pat;
    for (int p = threadIdx.x; p < a.n_pat; p += blockDim.x) {
      const int v = s_row[p];
      if (v != 0) {
        a.rowmap[r * a.rowmap_stride + p] = 1;
        s_tot[p] += v;
        s_row[p] = 0;
      }
    }
    half ^= 1;
  };
  ex::walk(a.rows, a.row_stride, rows, span, live, slots, after);
  __syncthreads();
  apm::flush_counts(s_tot, a.fcnt, a.n_pat);
}

}  // namespace

// Adds piece-hit totals to fcnt[pat0 + p] and sets rowmap[r * rowmap_stride
// + pat0 + p] = 1 where row r holds a hit of pattern pat0 + p (the caller
// zeroes both). rows and row_stride must be multiples of 16 bytes, prefix
// 16-byte aligned; `grid` blocks walk the rows grid-stride. Returns the
// launch's cudaError_t (0 on success).
extern "C" int apm_pieces_fused_count(
    const uint8_t* rows, int64_t n_staged, int64_t row_stride, int64_t n_rows,
    const uint8_t* piece, int n_piece, int piece_stride, const int32_t* plen,
    const int32_t* owner, const void* prefix, int pat0, int n_pat, int64_t wf,
    int64_t bound, int64_t start, int32_t* fcnt, int32_t* rowmap,
    int64_t rowmap_stride, int grid, void* stream) {
  if (grid <= 0 || n_piece <= 0 || n_pat <= 0 || piece_stride <= 0 ||
      wf <= 0 || (uintptr_t)rows % 16 != 0 || row_stride % 16 != 0 ||
      (uintptr_t)prefix % 16 != 0 ||
      row_stride < wf + kReach + piece_stride - 1 ||
      row_stride < wf + kReach + ex::kW + 8) {
    return (int)cudaErrorInvalidValue;
  }
  const PieceArgs a{rows,  n_staged, row_stride, n_rows, piece,
                    n_piece, piece_stride, plen, owner,
                    static_cast<const uint4*>(prefix), pat0, n_pat, wf,
                    bound, start, fcnt + pat0, rowmap + pat0, rowmap_stride};
  const size_t smem = (size_t)n_piece * (sizeof(uint4) + 2 * sizeof(int)) +
                      3 * (size_t)n_pat * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        pieces_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  pieces_fused_kernel<<<grid, ex::threads_for(wf + kReach), smem,
                        (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
