// Paired-window banded DP shared by the count kernels A and C (dp_band.cu,
// dp_myers.cu: their count, batch and dynamic-length entries) and the mask
// kernels #6 (dp_mask.cu).
//
// A block walks tiles of kWin = 512 windows of one row, grid-stride; each
// thread scans two neighbouring windows (lanes 2t and 2t + 1 of the tile).
// The tile's text (kWin + m_max bytes) is staged once into shared memory
// and every pattern is scanned from it, so the text crosses HBM once a
// tile, not once a pattern.
// - Band: the two windows' band cells live in the two 16-bit halves of one
//   register and each step updates both with Hopper's DPX min-plus
//   instructions. With u = v + 1 kept beside each cell v and
//   x = text ^ pattern (0 iff equal, per half):
//     v' = min(min(v + x, u), u_next, u_prev')   (__viaddmin, __vimin3)
//     u' = v' + 1                                (one add: no carry)
//   four instructions a cell for two windows. The cells are not clamped at
//   k + 1 each step as in apm's kernel: min(v, k + 1) equals apm's clamped
//   cell all the same (clamping commutes with the min-plus recurrence), so
//   the <= k verdict is exact; a cell grows by at most 1 a step, and a
//   clamp at k + 2 every kRenorm steps keeps each half below 2^16 for any
//   length (k + 1 < kCapMax). The text pair of step x is bytes x - 1 and x
//   of the thread's staged text (one shared load a step, the other byte
//   carried over); the pattern bytes come from a shared table of
//   byte * 0x10001 words, so each step loads one word. The first ke steps,
//   which reach the boundary column (y == 0 -> x, y < 0 -> k + 1), are
//   unrolled with the band's width. The text is staged by cp.async one
//   tile ahead (two buffers). A launch whose pattern table passes
//   kTableBytes (one pattern longer than about 8 K bytes) stages nothing:
//   its threads read the text from the staged rows and the pattern bytes
//   from the table in global memory, on the same steps. Bands wider than
//   kRegMax keep one window at a time in a global scratch slab (int32
//   cells), on the same tiles.
// - Myers: the staged text is translated once per tile to alphabet
//   channels (bytes outside the alphabet to a zero column of the shared
//   PEQ table), so a step is one shared channel load and one match-word
//   load per window with no branch. Up to k = 7 (2k + 1 <= 15 bits) the
//   thread's two windows share one VP/VN/centre word, one in each 16-bit
//   field: one chain of Hyyro's steps advances both (the add's carry stays
//   inside its field's spare bits, which the masks clear; the centre
//   values never exceed m < 2^16). Wider bands run the two windows as two
//   independent chains.
// Grid: blocks_per_sm(ke) blocks an SM, the same number as the kernels'
// __launch_bounds__, cut so every block walks the same number of tiles.
#pragma once

#include <algorithm>

#include "scan_common.cuh"

namespace apm {
namespace pair {

constexpr int kThreads = kTile;          // threads a block
constexpr int kWin = 2 * kThreads;       // windows a tile: two a thread
constexpr int kRegMax = 16;              // widest band half-width in registers
constexpr int kMaxBits = 29;             // Myers: 2k + 1 for apm's MYERS_KMAX = 14
constexpr int kTableBytes = 32 * 1024;   // band: widest shared pattern table
constexpr uint32_t kOne2 = 0x00010001u;
constexpr int kRenorm = 1 << 14;         // band steps between clamps of the cells
constexpr int kCapMax = 1 << 14;         // band: k + 1 below it (cells fit 16 bits)

// Blocks an SM of the band kernels with half-width KE (KE < 0: the wide
// band), for __launch_bounds__ and the grid: ptxas (sm_90a) gives the
// pair in registers about 40 + 8 KE registers a thread (39 at KE = 1, 50
// at 3, 156 at 16; the wide band 39), and an SM holds 64 K.
constexpr int band_blocks(int ke) {
  return ke <= 1 ? 6 : (256 / (40 + 8 * ke) > 1 ? 256 / (40 + 8 * ke) : 1);
}
constexpr int kMyersBlocks = 8;  // Myers kernels: 32 registers a thread

// Blocks an SM of a pair kernel for band half-width ke (ke < 0: Myers).
inline int blocks_per_sm(int ke) {
  return ke < 0 ? kMyersBlocks : band_blocks(ke > kRegMax ? -1 : ke);
}

// Grid of a launch over n_tiles tiles: per_sm blocks on every SM, at most
// `cap` (when positive) and n_tiles, cut so that every block walks the
// same number of tiles (no half wave).
inline cudaError_t pair_grid(int64_t n_tiles, int per_sm, int cap, int* grid) {
  int dev = 0, sms = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return e;
  int64_t g = std::min<int64_t>((int64_t)sms * per_sm, n_tiles);
  if (cap > 0) g = std::min<int64_t>(g, cap);
  const int64_t per_block = (n_tiles + g - 1) / g;
  *grid = (int)((n_tiles + per_block - 1) / per_block);
  return cudaSuccess;
}

template <class Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// Arguments of every pair kernel; a mode reads the fields it names.
struct Args {
  const uint8_t* rows;  // (n_rows, row_stride) staged corpus rows
  int64_t n_rows;
  int64_t row_stride;   // wf + halo
  const uint8_t* pat;   // band: (n_pat, pat_stride) k-padded pattern table
  int64_t pat_stride;   // band: m_max + 2k
  const int32_t* peq;   // Myers: (n_pat * m_max, n_chan) match words
  const uint8_t* alph;  // Myers: (n_chan,) distinct pattern bytes
  int n_chan;
  int n_pat;
  int m_max;
  const int32_t* plens; // (n_pat,) pattern lengths, 0 = padding slot
  int k;
  int ke;               // band: half-width computed, min(k, m_max)
  int64_t wf;
  int64_t bound;
  const int64_t* dbound;  // optional device-side bound (overrides bound)
  int64_t start;
  const int64_t* dstart;  // optional device-side start (overrides start)
  int32_t* out;         // (n_pat,) counts, accumulated with atomics
  const int32_t* meta;  // batch: (n_rows / 8, 2) [bound, start] a row block
  int64_t out_stride;   // batch: slot b of the counts at out + b * out_stride
  uint8_t* mask;        // mask: verdicts, row r at mask + r * mask_stride
  int64_t mask_stride;
  int32_t* scratch;     // wide bands only: (grid, 2ke + 1, kThreads) int32
  int stage_words;      // staged text words a tile: (kWin + m_max) / 4 up
  bool async_ok;        // rows and row_stride 4-byte aligned: cp.async
  bool pair_store;      // mask: wf, mask and mask_stride even, 16-bit stores
  bool packed;          // Myers: both windows in one bit band (2k + 1 <= 15)
};

inline Args base_args(const uint8_t* rows, int64_t n_rows, int64_t row_stride, int n_pat,
                      int m_max, const int32_t* plens, int k, int64_t wf, int64_t bound,
                      const int64_t* dbound, int64_t start, int32_t* out) {
  Args a{};
  a.rows = rows;
  a.n_rows = n_rows;
  a.row_stride = row_stride;
  a.n_pat = n_pat;
  a.m_max = m_max;
  a.plens = plens;
  a.k = k;
  a.wf = wf;
  a.bound = bound;
  a.dbound = dbound;
  a.start = start;
  a.out = out;
  a.stage_words = (int)((kWin + m_max + 3) / 4);
  a.async_ok = (uintptr_t)rows % 4 == 0 && row_stride % 4 == 0;
  return a;
}

__host__ __device__ __forceinline__ int64_t tiles_per_row(const Args& a) {
  return (a.wf + kWin - 1) / kWin;
}

__host__ __device__ __forceinline__ int64_t n_tiles(const Args& a) {
  return a.n_rows * tiles_per_row(a);
}

// Lanes [0, limit) of row r are owned: the batch mode's per-block pair, or
// the launch's bound and start.
__device__ __forceinline__ int64_t row_limit(const Args& a, int64_t r, int64_t bound,
                                             int64_t start) {
  return a.meta != nullptr ? batch_limit(a.meta, r, a.wf)
                           : owned_limit(r, a.n_rows, a.wf, bound, start);
}

__device__ __forceinline__ void cp_async4(uint32_t* dst, const void* src, int n) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }

__device__ __forceinline__ void cp_async_wait_prev() { asm volatile("cp.async.wait_group 1;\n" ::); }

__device__ __forceinline__ void cp_async_wait_all() { asm volatile("cp.async.wait_all;\n" ::); }

// Copies the text of tile t (kWin + m_max bytes from its first lane, zeros
// past the row's end) into dst: by cp.async when the rows are 4-byte
// aligned (the caller commits and waits), else byte by byte.
__device__ __forceinline__ void stage_text(const Args& a, int64_t t, uint32_t* dst) {
  const int64_t r = t / tiles_per_row(a);
  const int64_t lane0 = (t - r * tiles_per_row(a)) * kWin;
  const uint8_t* src = a.rows + r * a.row_stride + lane0;
  const int64_t avail = a.row_stride - lane0;
  for (int w = threadIdx.x; w < a.stage_words; w += blockDim.x) {
    const int64_t b = 4 * (int64_t)w;
    if (a.async_ok) {  // avail is a multiple of 4: no word straddles the end
      cp_async4(dst + w, b < avail ? src + b : src, b < avail ? 4 : 0);
    } else {
      uint32_t v = 0;
      for (int i = 0; i < 4; ++i) {
        if (b + i < avail) v |= (uint32_t)src[b + i] << (8 * i);
      }
      dst[w] = v;
    }
  }
}

// ---------------------------------------------------------------- band mode

// Where a window pair reads its text bytes (text(x): byte x from window
// 2t's first) and its pattern words (word(i): byte i * 0x10001).
struct SharedSrc {  // the block's staged tile and shared pattern table
  const uint8_t* txt;
  const uint32_t* pat;
  __device__ __forceinline__ uint32_t text(int x) const { return txt[x]; }
  __device__ __forceinline__ uint32_t word(int i) const { return pat[i]; }
};

struct GlobalSrc {  // the staged row and the k-padded table in global memory
  const uint8_t* txt;
  const uint8_t* pat;
  int64_t avail;  // bytes of the row from txt on (an odd wf's last pair)
  __device__ __forceinline__ uint32_t text(int x) const { return x < avail ? txt[x] : 0u; }
  __device__ __forceinline__ uint32_t word(int i) const { return pat[i] * kOne2; }
};

// One DP step x of the window pair: the 2KE + 1 cells from the text pair
// t2 and the pattern words pc. BOUNDARY steps (x <= KE) overwrite the
// cells of column y = 0 with x and of y < 0 with k + 1.
template <int KE, bool BOUNDARY>
__device__ __forceinline__ void band_step(uint32_t (&v)[2 * KE + 1], uint32_t (&u)[2 * KE + 1],
                                          const uint32_t (&pc)[2 * KE + 1], uint32_t t2, int x,
                                          uint32_t cap) {
  constexpr int BW = 2 * KE + 1;
  uint32_t uprev = cap;  // read only from di = 1 on
#pragma unroll
  for (int di = 0; di < BW; ++di) {
    uint32_t c = __viaddmin_u16x2(v[di], t2 ^ pc[di], u[di]);
    if (di + 1 < BW) {
      c = di > 0 ? __vimin3_u16x2(c, u[di + 1], uprev) : __vminu2(c, u[di + 1]);
    } else if (di > 0) {
      c = __vminu2(c, uprev);
    }
    if (BOUNDARY) {
      const int y = x + di - KE;
      if (y == 0) c = (uint32_t)x * kOne2;  // x <= KE <= k < k + 1
      if (y < 0) c = cap;
    }
    v[di] = c;
    u[di] = c + kOne2;  // no carry: halves < 2^16
    uprev = u[di];
  }
}

// Verdict pair (bit 0: window 2t, bit 1: window 2t + 1) of a band held in
// registers; s.word(di) is the pattern's word of byte (x - 1 + di) at x = 1.
// k + 1 < kCapMax.
template <int KE, class Src>
__device__ __forceinline__ int verdict_pair(const Src& s, int m, int k) {
  constexpr int BW = 2 * KE + 1;
  const uint32_t cap = (uint32_t)(k + 1) * kOne2, cap1 = (uint32_t)(k + 2) * kOne2;
  uint32_t v[BW], u[BW], pc[BW];
#pragma unroll
  for (int di = 0; di < BW; ++di) {
    v[di] = di >= KE ? (uint32_t)(di - KE) * kOne2 : cap;  // D[0][y] = y; y < 0 out of band
    u[di] = v[di] + kOne2;
    pc[di] = 0;
  }
#pragma unroll
  for (int di = 0; di + 1 < BW; ++di) pc[di + 1] = s.word(di);
  uint32_t hi = s.text(0);
#pragma unroll
  for (int x = 1; x <= KE; ++x) {  // the steps that reach the boundary
    if (x > m) break;
#pragma unroll
    for (int di = 0; di + 1 < BW; ++di) pc[di] = pc[di + 1];
    pc[BW - 1] = s.word(x - 1 + BW - 1);
    const uint32_t lo = hi;
    hi = s.text(x);
    band_step<KE, true>(v, u, pc, lo | (hi << 16), x, cap);
  }
  // A cell grows by at most 1 a step: clamping every kRenorm steps keeps
  // each half below 2^16 (with the add's + 255) for any pattern length.
  for (int x0 = KE + 1; x0 <= m; x0 += kRenorm) {
    const int x1 = min(m, x0 + kRenorm - 1);
#pragma unroll 2
    for (int x = x0; x <= x1; ++x) {
#pragma unroll
      for (int di = 0; di + 1 < BW; ++di) pc[di] = pc[di + 1];
      pc[BW - 1] = s.word(x - 1 + BW - 1);
      const uint32_t lo = hi;
      hi = s.text(x);
      band_step<KE, false>(v, u, pc, lo | (hi << 16), x, cap);
    }
#pragma unroll
    for (int di = 0; di < BW; ++di) {
      v[di] = __vminu2(v[di], cap1);
      u[di] = v[di] + kOne2;
    }
  }
  return (int)((int)(v[KE] & 0xffffu) <= k) | ((int)((int)(v[KE] >> 16) <= k) << 1);
}

// Window 2t + w of any band width, int32 cells in this thread's global
// scratch column (cell di at cell[di * kThreads]).
template <class Src>
__device__ int verdict_wide(const Src& s, int w, int m, int k, int ke, int32_t* __restrict__ cell) {
  const int bw = 2 * ke + 1;
  const int cap = k + 1;
  for (int di = 0; di < bw; ++di) cell[di * kThreads] = di >= ke ? di - ke : cap;
  for (int x = 1; x <= m; ++x) {
    const int t = (int)s.text(x - 1 + w);
    int prev = cap;
    int cur = cell[0];
    for (int di = 0; di < bw; ++di) {
      const int y = x + di - ke;
      const int nxt = di + 1 < bw ? cell[(di + 1) * kThreads] : cap;
      int v = cur + (t != (int)(s.word(x - 1 + di) & 0xffffu) ? 1 : 0);
      v = min(min(v, nxt + 1), min(prev + 1, cap));
      if (y == 0) v = x;
      if (y < 0) v = cap;
      cell[di * kThreads] = v;
      prev = v;
      cur = nxt;
    }
  }
  return cell[ke * kThreads] <= k ? 1 : 0;
}

// Verdict pair of the owned windows (`own`: bit 0 window 2t, bit 1 2t + 1)
// at distance k (k + 1 < kCapMax on the register path).
template <int KE, class Src>
__device__ __forceinline__ int band_hits(const Src& s, const Args& a, int k, int m, int own,
                                         int32_t* cell) {
  int hits;
  if constexpr (KE >= 0) {
    hits = verdict_pair<KE>(s, m, k);
  } else {
    hits = verdict_wide(s, 0, m, k, a.ke, cell);
    if (own & 2) hits |= verdict_wide(s, 1, m, k, a.ke, cell) << 1;
  }
  return hits & own;
}

// ---------------------------------------------------------------- Myers mode

// A bit band: VP, VN and the centre value. Packed, two windows share it,
// one in each 16-bit field (`one` = 0x00010001, `mask` the band's bits of
// both fields, cc two 16-bit counts); else `one` = 1.
struct BitBand {
  uint32_t vp, vn, cc;
};

// Hyyro's step. Packed, the add's carry out of the band's top bit lands in
// the field's spare bits (2k + 1 <= 15), which every mask clears before
// they reach anything but xh's unread top, so the fields never mix.
__device__ __forceinline__ void bit_step(BitBand& s, uint32_t eq, uint32_t mask, int cbit,
                                         uint32_t one) {
  const uint32_t xv = eq | s.vn;
  const uint32_t xh = (((eq & s.vp) + s.vp) ^ s.vp) | eq;
  uint32_t ph = s.vn | (~(xh | s.vp) & mask);
  uint32_t mh = s.vp & xh;
  ph = ((ph << 1) & mask) | one;  // horizontal carry-in = +1
  mh = (mh << 1) & mask;
  s.cc += one - (((xh | s.vn) >> cbit) & one);
  s.vp = mh | (~(xv | ph) & mask);
  s.vn = ph & xv;
}

// Two windows packed in the 16-bit fields of one bit band (2k + 1 <= 15):
// one chain for the pair, the match words of both joined into one.
__device__ __forceinline__ int verdict_myers_packed(const uint8_t* ch, const uint32_t* peq,
                                                    int c1, int m, int k) {
  const int bw = 2 * k + 1;
  const uint32_t mask = ((1u << bw) - 1u) * kOne2;
  const uint32_t top = (1u << (bw - 1)) * kOne2;
  BitBand s{mask, 0u, 0u};
  const int xs = m < k ? m : k;
  const uint32_t* row_k = peq + k * c1;
  int hi = ch[0];
  for (int x = 1; x <= xs; ++x) {
    const int lo = hi;
    hi = ch[x];
    bit_step(s, row_k[lo] | (row_k[hi] << 16), mask, x - 1, kOne2);
  }
  if (m > k) {
    s.vp = ((s.vp << 1) | kOne2) & mask;
    s.vn = (s.vn << 1) & mask;
    const uint32_t* row = peq + k * c1;
#pragma unroll 2
    for (int x = k + 1; x <= m; ++x) {
      s.vp = ((s.vp >> 1) & mask) | top;  // field 1's low bit lands in field 0's spare
      s.vn = (s.vn >> 1) & mask;
      const int lo = hi;
      hi = ch[x];
      bit_step(s, row[lo] | (row[hi] << 16), mask, k, kOne2);
      row += c1;
    }
  }
  return ((int)(s.cc & 0xffffu) <= k ? 1 : 0) | ((int)(s.cc >> 16) <= k ? 2 : 0);
}

__device__ __forceinline__ void shift_band(BitBand& s, uint32_t topbit) {
  s.vp = (s.vp >> 1) | topbit;
  s.vn >>= 1;
}

// Verdict pair of two windows' bit bands (kernel C's three phases).
// `ch` is the thread's first staged channel (window 2t's first byte),
// `peq` this pattern's first PEQ row in shared memory (stride n_chan + 1,
// the last column 0: bytes outside the alphabet).
__device__ __forceinline__ int verdict_myers_pair(const uint8_t* ch, const uint32_t* peq,
                                                  int c1, int m, int k) {
  const int bw = 2 * k + 1;
  const uint32_t mask = (1u << bw) - 1u;
  const uint32_t topbit = 1u << (bw - 1);
  BitBand s0{mask, 0u, 0u}, s1{mask, 0u, 0u};
  const int xs = m < k ? m : k;
  const uint32_t* row_k = peq + k * c1;
  int hi = ch[0];
  for (int x = 1; x <= xs; ++x) {
    const int lo = hi;
    hi = ch[x];
    bit_step(s0, row_k[lo], mask, x - 1, 1u);
    bit_step(s1, row_k[hi], mask, x - 1, 1u);
  }
  if (m > k) {
    s0.vp = ((s0.vp << 1) | 1u) & mask;
    s0.vn = (s0.vn << 1) & mask;
    s1.vp = ((s1.vp << 1) | 1u) & mask;
    s1.vn = (s1.vn << 1) & mask;
    const uint32_t* row = peq + k * c1;
#pragma unroll 2
    for (int x = k + 1; x <= m; ++x) {
      shift_band(s0, topbit);
      shift_band(s1, topbit);
      const int lo = hi;
      hi = ch[x];
      bit_step(s0, row[lo], mask, k, 1u);
      bit_step(s1, row[hi], mask, k, 1u);
      row += c1;
    }
  }
  return ((int)s0.cc <= k ? 1 : 0) | ((int)s1.cc <= k ? 2 : 0);
}

// Shared memory of a Myers kernel: counters, lengths, the PEQ table with
// its zero column, the tile's channels and the byte -> channel table.
inline size_t myers_smem(const Args& a) {
  return sizeof(int) * 2 * (size_t)a.n_pat +
         sizeof(uint32_t) * ((size_t)a.n_pat * a.m_max * (a.n_chan + 1) + (size_t)a.stage_words) +
         256;
}

struct MyersSmem {
  int* cnt;        // (n_pat,)
  int* plen;       // (n_pat,)
  uint32_t* peq;   // (n_pat * m_max, n_chan + 1)
  uint32_t* ch;    // (stage_words,) channels
  uint8_t* lut;    // (256,)
};

// Lays out and fills a Myers kernel's shared memory (the LUT is complete
// after the caller's next __syncthreads()).
__device__ __forceinline__ MyersSmem load_myers(const Args& a, uint32_t* smem) {
  const int c1 = a.n_chan + 1;
  const int n_words = a.n_pat * a.m_max * c1;
  MyersSmem s;
  s.cnt = reinterpret_cast<int*>(smem);
  s.plen = s.cnt + a.n_pat;
  s.peq = smem + 2 * a.n_pat;
  s.ch = s.peq + n_words;
  s.lut = reinterpret_cast<uint8_t*>(s.ch + a.stage_words);
  for (int i = threadIdx.x; i < a.n_pat; i += blockDim.x) {
    s.cnt[i] = 0;
    s.plen[i] = a.plens[i];
  }
  for (int i = threadIdx.x; i < n_words; i += blockDim.x) {
    const int row = i / c1, c = i - row * c1;
    s.peq[i] = c < a.n_chan ? (uint32_t)a.peq[row * a.n_chan + c] : 0u;
  }
  for (int i = threadIdx.x; i < 256; i += blockDim.x) s.lut[i] = (uint8_t)a.n_chan;
  __syncthreads();
  if (threadIdx.x < a.n_chan) s.lut[a.alph[threadIdx.x]] = (uint8_t)threadIdx.x;
  return s;
}

// Stages the channels of the tile at lane0 of row r (bytes past the row's
// end to the zero column).
__device__ __forceinline__ void stage_channels(const Args& a, int64_t r, int64_t lane0,
                                               const MyersSmem& s) {
  const uint8_t* src = a.rows + r * a.row_stride + lane0;
  const int64_t avail = a.row_stride - lane0;
  for (int w = threadIdx.x; w < a.stage_words; w += blockDim.x) {
    const int64_t b = 4 * (int64_t)w;
    uint32_t bytes = 0;
    if (a.async_ok && b + 4 <= avail) {
      bytes = *reinterpret_cast<const uint32_t*>(src + b);
    } else {
      for (int i = 0; i < 4; ++i) {
        if (b + i < avail) bytes |= (uint32_t)src[b + i] << (8 * i);
      }
    }
    uint32_t chans = 0;
    for (int i = 0; i < 4; ++i) {
      const uint32_t c = b + i < avail ? s.lut[(bytes >> (8 * i)) & 0xffu] : (uint32_t)a.n_chan;
      chans |= c << (8 * i);
    }
    s.ch[w] = chans;
  }
}

// Verdict pair of the owned windows of a Myers tile.
__device__ __forceinline__ int myers_hits(const Args& a, const MyersSmem& s, int p, int m,
                                          int own) {
  const int c1 = a.n_chan + 1;
  const uint8_t* ch = reinterpret_cast<const uint8_t*>(s.ch) + 2 * threadIdx.x;
  const uint32_t* peq = s.peq + (int64_t)p * a.m_max * c1;
  return (a.packed ? verdict_myers_packed(ch, peq, c1, m, a.k)
                   : verdict_myers_pair(ch, peq, c1, m, a.k)) & own;
}

// Checks shared by the Myers entries (1 <= k, 2k + 1 <= 29, k < m_max,
// 1 <= n_chan <= 32).
inline bool bad_myers(int64_t n_rows, int n_pat, int m_max, int n_chan, int k, int64_t wf) {
  return n_rows <= 0 || n_pat <= 0 || wf <= 0 || k < 1 || 2 * k + 1 > kMaxBits || k >= m_max ||
         n_chan < 1 || n_chan > 32;
}

}  // namespace pair
}  // namespace apm
