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
// What bounds it on an H100: integer instructions. The staged rows are
// read once (a 256 MB chunk: 0.08 ms at 3.35 TB/s), but every text
// position a window can reach is tested against every piece, and on random
// text almost every test fails within one or two bytes. A design of one
// thread per position, a byte compare chain against an int32 table in
// global memory and a byte hit map per piece in shared memory (two
// barriers per piece and tile, span + 1 shared loads per window and piece)
// reached 4.4 % of the bound.
//
// Design (the ideas of exact_scan.cuh: a tile of 32 windows per thread,
// compares on packed words, no reduction per window):
// - The unit of work, an item, is a group of n consecutive staged rows or
//   one row segment. A thread owns the 32 windows of one tile of one row.
//   Where a row's tiles are fewer than half a block (wf a multiple of 32),
//   an item takes n whole rows, so every thread of the block owns windows:
//   64 rows of 4 tiles at wf = 128; otherwise it takes a segment of one row,
//   blockDim.x tiles long. filter_kernel.item_rows chooses n, the block and
//   the row slot from wf, the halo, the group's pieces and patterns and the
//   device's shared memory, and the entry takes that choice as it is.
// - One staging of the text per item, by cp.async into one of three shared
//   buffers: the next item's text loads while this item's pieces run, and
//   three buffers make one barrier per item enough. Each of the item's rows
//   sits in its own slot (its tiles and its halo), so a window reads its own
//   row's bytes whatever the rows hold; bytes past the row's end are
//   zero-filled by the copy itself, and a pad after the last slot keeps
//   every word read inside the buffer. The buffer keeps a 4-byte gap after
//   every 32 text bytes: thread t reads from byte 32t of its slot on, and a
//   36-byte stride puts the lanes of a warp on different banks; the slot's
//   length, a multiple of 32 bytes, is chosen so that this holds across the
//   rows that share a warp too. At the capture panel's shape (64 patterns,
//   448 pieces, wf = 128, a 256-byte halo) a block of 64 rows takes 112.6
//   KB, two blocks an SM; two buffers would not fit a third block, and 32
//   rows an item (three blocks of four warps an SM) ran 8 % slower on an
//   H100, so three buffers and the full block stay.
// - Per piece, a thread builds the 4-byte text words at the positions its
//   windows reach (aligned word loads, then __funnelshift_r) and tests the
//   piece's 8-byte head word at each: one hit bit per position, 32 + span
//   positions in a 64-bit mask. Only set bits read the rest of the piece.
//   A window is a candidate when a hit lies in [w, w + span]: the OR of the
//   mask shifted by 0..span, done by doubling on one register per thread
//   and piece, not per window.
// - Banded tier (kp = 1, li >= 14): one edit leaves one half of the piece
//   intact, so a hit at T needs the first h = min(8, li/2) bytes at T or
//   the last h' = min(8, ceil(li/2)) bytes at T + li - h' + d, d in
//   {-1, 0, 1} (the three drifts are one tail-word mask shifted by 0, 1
//   and 2). Only positions that pass run the band (hit_banded), so the hit
//   bit is the band's own and the test only drops positions that cannot
//   hit.
// - A thread counts a pattern's candidates over its 32 windows with one
//   popc; the lanes of a warp that share a row sum theirs with one
//   __reduce_add_sync, and the first of them adds a nonzero sum to rowmap
//   with one global atomic and to the block's shared totals, which reach
//   fcnt with one atomic per nonzero (block, pattern). A row of several
//   warps (wf >= 2048) gets one atomic per warp and pattern: one reduction
//   for every shape, with no shared row counters to flush between items.
// - The grid is the card's residency for the block and shared memory
//   chosen (cudaOccupancyMaxActiveBlocksPerMultiprocessor), capped at the
//   items, which the blocks walk grid-stride.
// Tensor cores do not apply: the work is integer equality tests with early
// exit, not a product (the TPU's bit-plane matmul was its way to compare
// bytes on a matrix unit).
#include <algorithm>

#include "scan_common.cuh"

namespace {

constexpr int kInf = 1 << 20;      // additive-safe INF of out-of-band cells
constexpr int kW = 32;             // windows per thread
constexpr int kMaxThreads = 256;   // 8 warps cover an 8192-window row
constexpr int kMinBlocksPerSm = 4; // __launch_bounds__: at most 64 registers a thread
constexpr int kStages = 3;         // staging buffers: one barrier per item
constexpr int kLayoutInts = 8;     // ints per piece from the host (filter_kernel.piece_layout)
constexpr int kReachPad = 128;     // buffer bytes past the last slot

// One piece in shared memory: its filter_kernel.piece_layout row, then the
// words this kernel builds from the char table.
struct Piece {
  int off, span, li, kp;  // first position o + s_lo, s_hi - s_lo, length, tier
  int o, tail_off, n_head, n_tail;  // offset in the pattern, tail offset, word bytes
  uint4 head, tail;       // word lo, hi, mask lo, hi (corr_fused.prefix_words' order)
};
static_assert(sizeof(Piece) == 8 * kLayoutInts, "Piece is a layout row and two words");

struct FilterArgs {
  const uint8_t* rows;  // (n_rows, row_stride) staged corpus rows
  int64_t n_rows;
  int64_t row_stride;   // wf + halo, a multiple of 4
  const int32_t* pchar; // (n_pat, pchar_stride) sentinel-padded bytes
  int n_pat;
  int64_t pchar_stride;
  int pad;              // front sentinel columns (max kp)
  const int32_t* pieces;  // (n_piece, kPieceInts) of the group
  int n_piece;
  const int32_t* pstart;  // (n_pat + 1,) piece range of each pattern
  int64_t wf;
  int64_t bound;
  int64_t start;
  int32_t* fcnt;        // (n_pat,) candidate totals, accumulated
  int32_t* rowmap;      // (n_rows, rowmap_stride) per-row candidates
  int64_t rowmap_stride;
  int item_rows;        // rows of an item (filter_kernel.item_rows)
  int slot_words;       // logical words of a row's slot, a multiple of 8
};

// Staged buffers: logical byte x (from the first slot's first byte) sits at
// physical byte x + 4 * (x / 32).
__device__ __forceinline__ int phys_word(int wi) { return wi + (wi >> 3); }

__device__ __forceinline__ int text_at(const uint32_t* buf, int x) {
  return reinterpret_cast<const uint8_t*>(buf)[x + ((x >> 5) << 2)];
}

__device__ __forceinline__ uint32_t word_at(const uint32_t* w, int i) {
  return (i & 3) == 0 ? w[i >> 2]
                      : __funnelshift_r(w[i >> 2], w[(i >> 2) + 1], (i & 3) * 8);
}

// The first n (<= 8) bytes at b, little-endian, and their mask.
__device__ __forceinline__ uint4 pack_word(const int32_t* __restrict__ b, int n) {
  uint32_t w[2] = {0, 0}, m[2] = {0, 0};
  for (int j = 0; j < n; ++j) {
    w[j >> 2] |= (uint32_t)(b[j] & 0xff) << (8 * (j & 3));
    m[j >> 2] |= 0xffu << (8 * (j & 3));
  }
  return make_uint4(w[0], w[1], m[0], m[1]);
}

// Bit i (i < N) set iff the 8 bytes at logical byte x + i equal `pre`'s word
// under its mask (pre = {word lo, word hi, mask lo, mask hi}).
template <int N>
__device__ __forceinline__ uint64_t eq_bits(const uint32_t* __restrict__ buf, int x,
                                            uint4 pre) {
  constexpr int NW = (N + 3) / 4 + 2;  // words of bytes [x, x + N + 8)
  const int a = x >> 2, sh = (x & 3) * 8;
  uint32_t raw[NW + 1];
#pragma unroll
  for (int k = 0; k <= NW; ++k) raw[k] = buf[phys_word(a + k)];
  uint32_t w[NW];
#pragma unroll
  for (int k = 0; k < NW; ++k) w[k] = __funnelshift_r(raw[k], raw[k + 1], sh);
  uint32_t lo = 0, hi = 0;
  if ((pre.z & pre.w) == 0xffffffffu) {  // 8-byte head: uniform over the block
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if (word_at(w, i) == pre.x && word_at(w, i + 4) == pre.y) {
        if (i < 32) lo |= 1u << (i & 31); else hi |= 1u << (i & 31);
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < N; ++i) {
      if ((((word_at(w, i) ^ pre.x) & pre.z) | ((word_at(w, i + 4) ^ pre.y) & pre.w)) == 0) {
        if (i < 32) lo |= 1u << (i & 31); else hi |= 1u << (i & 31);
      }
    }
  }
  return ((uint64_t)hi << 32) | lo;
}

// Banded tier (kp = 1): pinned-start width-3 band; `pc` points at the
// piece's first byte in the sentinel-padded table (pc[-1] is readable).
// Cell di = d + 1 after t steps holds D[t + d][t]; the verdict is the
// minimum of cell d after li - d steps, d in [-1, 1], against 1.
__device__ __forceinline__ bool hit_banded(const uint32_t* buf, int x,
                                           const int32_t* __restrict__ pc,
                                           int li) {
  int b0 = kInf, b1 = 0, b2 = 1;
  int cap = kInf;
  for (int t = 1; t <= li + 1; ++t) {
    const int c = text_at(buf, x + t - 1);
    const int n0 = min(b0 + (c != pc[t - 2] ? 1 : 0), b1 + 1);
    const int n1 = min(min(b1 + (c != pc[t - 1] ? 1 : 0), b2 + 1), n0 + 1);
    const int n2 = min(b2 + (c != pc[t] ? 1 : 0), n1 + 1);
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
  return cap <= 1;
}

// Hits of piece `pc` at the N positions from logical byte x: the head-word
// bits, then the rest of the piece (exact tier) or the band (banded tier)
// on the survivors only.
template <int N>
__device__ __forceinline__ uint64_t block_hits(const uint32_t* buf, int x,
                                               const Piece& pc,
                                               const int32_t* __restrict__ pch) {
  uint64_t h = eq_bits<N>(buf, x, pc.head);
  if (pc.kp == 0) {
    if (pc.li <= 8) return h;  // the head word covered the whole piece
    uint64_t out = 0;
    while (h != 0) {
      const int i = __ffsll((long long)h) - 1;
      h &= h - 1;
      int b = 8;
      while (b < pc.li && text_at(buf, x + i + b) == pch[pc.o + b]) ++b;
      if (b >= pc.li) out |= 1ull << i;
    }
    return out;
  }
  const uint64_t g = eq_bits<N + 2>(buf, x + pc.tail_off, pc.tail);
  uint64_t pass = (h | g | (g >> 1) | (g >> 2)) & ((N >= 64 ? 0ull : 1ull << N) - 1);
  uint64_t out = 0;
  while (pass != 0) {
    const int i = __ffsll((long long)pass) - 1;
    pass &= pass - 1;
    if (hit_banded(buf, x + i, pch + pc.o, pc.li)) out |= 1ull << i;
  }
  return out;
}

// Bit w set iff some bit of [w, w + span] is set in `hits`.
__device__ __forceinline__ uint32_t spread(uint64_t hits, int span) {
  int c = 1;
  while (2 * c <= span + 1) {
    hits |= hits >> c;
    c <<= 1;
  }
  return (uint32_t)(hits | (hits >> (span + 1 - c)));
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const void* src, int n) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_prev() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

// Issue the copies of an item's text: for each of its rows r0 + i below
// n_rows, logical words [0, slot_words) of slot i from the row's byte seg0,
// zero past the row's end (a copy of 0 source bytes).
__device__ __forceinline__ void stage(uint32_t* buf, const FilterArgs& a, int64_t r0,
                                      int64_t seg0) {
  const int64_t avail = a.row_stride - seg0;
  const int64_t left = a.n_rows - r0;
  const int live = left < a.item_rows ? (int)left : a.item_rows;
  for (int wi = threadIdx.x; wi < live * a.slot_words; wi += blockDim.x) {
    const int i = wi / a.slot_words;
    const int64_t b = 4 * (int64_t)(wi - i * a.slot_words);
    const uint8_t* row = a.rows + (r0 + i) * a.row_stride;
    const bool in = b < avail;
    cp_async4(buf + phys_word(wi), in ? row + seg0 + b : row, in ? 4 : 0);
  }
}

__global__ void __launch_bounds__(kMaxThreads, kMinBlocksPerSm) filter_pieces_kernel(FilterArgs a) {
  extern __shared__ uint4 smem4[];
  Piece* s_piece = reinterpret_cast<Piece*>(smem4);             // (n_piece,)
  int* s_pstart = reinterpret_cast<int*>(s_piece + a.n_piece);  // (n_pat + 1,)
  int* s_tot = s_pstart + a.n_pat + 1;                          // (n_pat,) block totals
  const int stage_words = a.item_rows * a.slot_words + kReachPad / 4;
  const int buf_words = stage_words + stage_words / 8;
  uint32_t* s_txt = reinterpret_cast<uint32_t*>(s_tot + a.n_pat);  // kStages buffers

  int* s_tab = reinterpret_cast<int*>(s_piece);
  for (int i = threadIdx.x; i < a.n_piece * kLayoutInts; i += blockDim.x) {
    s_tab[2 * i - i % kLayoutInts] = a.pieces[i];  // row i / 8, column i % 8
  }
  for (int i = threadIdx.x; i <= a.n_pat; i += blockDim.x) s_pstart[i] = a.pstart[i] - a.pstart[0];
  apm::zero_counts(s_tot, a.n_pat);
  __syncthreads();
  // the words, from the char table: the host sends the layout only
  for (int p = threadIdx.x; p < a.n_pat; p += blockDim.x) {
    const int32_t* pch = a.pchar + (int64_t)p * a.pchar_stride + a.pad;
    for (int q = s_pstart[p]; q < s_pstart[p + 1]; ++q) {
      Piece& pc = s_piece[q];
      pc.head = pack_word(pch + pc.o, pc.n_head);
      pc.tail = pack_word(pch + pc.o + pc.li - pc.n_tail, pc.n_tail);
    }
  }

  // This thread's row slot and tile; the lanes of its warp in the same
  // slot, [g0, g1), sum their counts.
  const int tiles = blockDim.x / a.item_rows;  // tiles of a row an item
  const int slot = threadIdx.x / tiles;
  const int tile = threadIdx.x - slot * tiles;
  const int lane = threadIdx.x & 31, warp0 = threadIdx.x - lane;
  const int g0 = max(slot * tiles - warp0, 0), g1 = min((slot + 1) * tiles - warp0, 32);
  const unsigned group = (g1 - g0 == 32 ? 0xffffffffu : (1u << (g1 - g0)) - 1u) << g0;
  const int x0 = slot * a.slot_words * 4 + tile * kW;  // logical byte of the first window

  const int64_t seg = (int64_t)tiles * kW;
  const int64_t segs = (a.wf + seg - 1) / seg;
  const int64_t n_items = (a.n_rows + a.item_rows - 1) / a.item_rows * segs;
  // first row and first window of item t
  auto item = [&](int64_t t, int64_t& r0, int64_t& seg0) {
    const int64_t g = segs == 1 ? t : t / segs;
    r0 = g * a.item_rows;
    seg0 = (t - g * segs) * seg;
  };

  // issue the copies of item t into buffer b, if it is live
  auto prefetch = [&](int64_t t, int b) {
    if (t < n_items) {
      int64_t r0, seg0;
      item(t, r0, seg0);
      if (seg0 < apm::owned_limit(r0, a.n_rows, a.wf, a.bound, a.start)) {
        stage(s_txt + b * buf_words, a, r0, seg0);
      }
    }
    cp_async_commit();
  };

  int64_t t = blockIdx.x;
  prefetch(t, 0);
  for (int it = 0; t < n_items; ++it) {  // uniform over the block
    const int64_t tn = t + gridDim.x;
    prefetch(tn, (it + 1) % kStages);
    cp_async_wait_prev();  // this item's copies (this thread's) have landed
    __syncthreads();       // everyone's have; buffer (it + 1) % kStages is free

    int64_t r0, seg0;
    item(t, r0, seg0);
    const int64_t r = r0 + slot;
    const int64_t j0 = seg0 + (int64_t)tile * kW;
    const int64_t lim = apm::owned_limit(r, a.n_rows, a.wf, a.bound, a.start);
    const int nown = j0 >= lim ? 0 : lim - j0 < kW ? (int)(lim - j0) : kW;
    const uint32_t own = nown >= 32 ? 0xffffffffu : (1u << nown) - 1u;
    const uint32_t* buf = s_txt + (it % kStages) * buf_words;
    for (int p = 0; p < a.n_pat; ++p) {
      const int q1 = s_pstart[p + 1];
      const int32_t* pch = a.pchar + (int64_t)p * a.pchar_stride + a.pad;
      uint32_t cand = 0;
      for (int q = s_pstart[p]; q < q1 && (cand & own) != own; ++q) {
        const Piece pc = s_piece[q];
        const int x = x0 + pc.off;
        uint64_t hits = block_hits<32>(buf, x, pc, pch);
        if (pc.span > 0) {  // positions 32 .. 31 + span
          const uint64_t h1 = pc.span <= 8    ? block_hits<8>(buf, x + 32, pc, pch)
                              : pc.span <= 16 ? block_hits<16>(buf, x + 32, pc, pch)
                                              : block_hits<32>(buf, x + 32, pc, pch);
          hits |= h1 << 32;
        }
        if (hits != 0) cand |= spread(hits, pc.span);
      }
      const unsigned c = __reduce_add_sync(group, (unsigned)__popc(cand & own));
      if (lane == g0 && c != 0) {
        atomicAdd(&a.rowmap[r * a.rowmap_stride + p], (int)c);
        atomicAdd(&s_tot[p], (int)c);
      }
    }
    t = tn;
  }
  cp_async_wait_all();
  __syncthreads();
  apm::flush_counts(s_tot, a.fcnt, a.n_pat);
}

// Dynamic shared memory of a block (filter_kernel.block_smem): the piece
// table, pattern ranges, totals and kStages staging buffers of item_rows
// slots and the pad, with a 4-byte gap after every 32 bytes.
size_t block_smem(int item_rows, int64_t slot_words, int n_piece, int n_pat) {
  const size_t words = (size_t)item_rows * slot_words + kReachPad / 4;
  return sizeof(Piece) * (size_t)n_piece + sizeof(int) * (2 * (size_t)n_pat + 1) +
         sizeof(uint32_t) * kStages * (words + words / 8);
}

}  // namespace

// Adds candidate counts to fcnt[p] and rowmap[r * rowmap_stride + p] (the
// caller zeroes both) for the n_pat patterns of one launch group, whose
// pieces (filter_kernel.piece_layout rows; the words are built here from
// pchar) and piece ranges pstart (absolute, n_pat + 1) are passed from
// their first. rows and row_stride must be multiples of 4 bytes. The block
// is filter_kernel.item_rows' choice: `threads` threads walk items of
// `item_rows` rows (then threads / item_rows * 32 == wf) or of one row's
// segment, each row in a slot of `slot` staged bytes (a multiple of 32 that
// holds the row's tiles and its halo). cudaErrorInvalidValue when the
// block's shared memory passes the device's limit (a halo too large). The
// grid is the device's residency for that block, capped at the items.
// Returns the launch's cudaError_t (0 on success).
extern "C" int apm_filter_pieces_count(
    const uint8_t* rows, int64_t n_rows, int64_t row_stride,
    const int32_t* pchar, int n_pat, int64_t pchar_stride, int pad,
    const int32_t* pieces, int n_piece, const int32_t* pstart, int64_t wf,
    int64_t bound, int64_t start, int32_t* fcnt, int32_t* rowmap,
    int64_t rowmap_stride, int item_rows, int threads, int64_t slot, void* stream) {
  const int64_t halo = row_stride - wf;
  if (n_rows <= 0 || n_pat <= 0 || n_piece <= 0 || pad < 0 || pad > 1 || wf <= 0 ||
      halo <= 0 || (uintptr_t)rows % 4 != 0 || row_stride % 4 != 0 || threads <= 0 ||
      threads > kMaxThreads || item_rows <= 0 || threads % item_rows != 0 ||
      (item_rows > 1 && (int64_t)threads / item_rows * kW != wf) || slot % 32 != 0 ||
      slot < (int64_t)threads / item_rows * kW + halo) {
    return (int)cudaErrorInvalidValue;
  }
  int dev = 0, sms = 0, smem_max = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&smem_max, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e != cudaSuccess) return (int)e;
  const size_t smem = block_smem(item_rows, slot / 4, n_piece, n_pat);
  if (smem > (size_t)smem_max) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    e = cudaFuncSetAttribute(filter_pieces_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, filter_pieces_kernel, threads, smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t seg = (int64_t)threads / item_rows * kW;
  const int64_t n_items = (n_rows + item_rows - 1) / item_rows * ((wf + seg - 1) / seg);
  const int grid = (int)std::min<int64_t>(n_items, (int64_t)sms * std::max(per_sm, 1));
  FilterArgs a{rows,   n_rows, row_stride, pchar, n_pat, pchar_stride, pad,
               pieces, n_piece, pstart,    wf,    bound, start,        fcnt,
               rowmap, rowmap_stride, item_rows, (int)(slot / 4)};
  filter_pieces_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
