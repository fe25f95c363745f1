// Exact-window scan shared by kernel B's count and batch modes (kernels B
// and #8, corr_fused.cu) and kernel #7 (corr_pieces.cu): a tile of windows
// per thread, compares on packed 8-byte words, no reduction per window.
//
// Both kernels ask, for every window j of a staged row and every slot (a
// pattern or a piece of m bytes), whether the m text bytes at j equal the
// slot's bytes. On random DNA text almost every answer is "no" after one
// or two bytes, so the work is the test itself and what surrounds it:
// loading the text, looping over slots, counting. This header does all
// three so that the common answer costs three instructions.
//
// - A tile of windows per thread. A block walks items (staged row,
//   segment of blockDim.x * kW windows) grid-stride; thread t owns the kW
//   consecutive windows [j0, j0 + kW), j0 = segment start + t * kW. It
//   reads the kW text bytes of its windows as two 16-byte vector loads
//   straight from global memory (row_stride and the row
//   pointer are multiples of 16, which the wrappers check), and the 8
//   bytes past them, which the next thread loaded, by __shfl_down_sync;
//   lane 31, and a thread whose successor is past the row's live
//   windows, loads those 8 bytes itself. The loads of the block's next
//   item are issued before the current item's compares, so they overlap
//   (a register double buffer; a shared-memory stage would add a barrier
//   per item and buys nothing here: every byte is read by one thread,
//   once).
// - Compares on packed words. From its kW + 8 bytes a thread builds, once
//   per item, the 4-byte words v[i] = text[j0 + i .. j0 + i + 3] with
//   __funnelshift_r; window i's 8-byte prefix is (v[i], v[i + 4]). Each
//   slot carries its 8-byte prefix word and a mask (prefix_words in
//   ops/corr_fused.py: the slot's first min(m, 8) bytes, little-endian;
//   the mask keeps those bytes). A slot of m >= 8 is tested with two
//   32-bit equalities per window, a shorter one with two masked XORs; the
//   hits of the kW windows land in one 32-bit mask.
// - Only a window whose prefix matches (about 4^-8 of windows on random
//   DNA) reads the slot's remaining m - 8 bytes, from global memory.
// - No reduction per window: a thread counts its verified hits of a slot
//   in a register over its kW windows and adds the sum to the block's
//   shared counter only when it is nonzero.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace apm {
namespace exact {

// Windows per thread: two 16-byte loads. 32 x 256 threads cover an
// 8192-window row; 32 ran faster than 16 for kernels B and #7 on the H100.
constexpr int kW = 32;
// Most threads of a block: 9 warps cover an 8192-window row plus kernel
// #7's 64 reach positions at kW = 32.
constexpr int kMaxThreads = 288;

// Threads of a block for rows of `span` windows: enough whole warps to
// give every window a thread, at most kMaxThreads.
inline int threads_for(int64_t span) {
  const int64_t tiles = (span + kW - 1) / kW;
  const int64_t warps = (tiles + 31) / 32;
  return warps * 32 < kMaxThreads ? (int)(warps * 32) : kMaxThreads;
}

// One thread's share of an item: its windows and their raw text bytes.
struct Chunk {
  int64_t r;   // staged row
  int64_t j0;  // first window of this thread in the row
  int nown;    // windows [j0, j0 + nown) are live, 0..kW
  bool tail;   // this thread loaded the 8 bytes past its windows itself
  uint4 a, b;  // text bytes [j0, j0 + 32)
  uint2 c;     // text bytes [j0 + kW, j0 + kW + 8) when `tail`
};

// The chunk of item t (past the last item: nothing live, nothing loaded).
// `live` is the row's number of live windows, at most the row's span.
template <class Live>
__device__ __forceinline__ Chunk fetch(const uint8_t* rows, int64_t row_stride,
                                       int64_t segs, int64_t n_items, int64_t t,
                                       Live live) {
  Chunk ch{};  // all zero: no live windows, no bytes
  if (t >= n_items) return ch;
  ch.r = segs == 1 ? t : t / segs;  // one segment a row: no 64-bit division
  ch.j0 = ((t - ch.r * segs) * blockDim.x + threadIdx.x) * (int64_t)kW;
  const int64_t rest = live(ch.r) - ch.j0;
  if (rest <= 0) return ch;
  ch.nown = rest < kW ? (int)rest : kW;
  const uint8_t* p = rows + ch.r * row_stride + ch.j0;
  ch.a = __ldg(reinterpret_cast<const uint4*>(p));
  ch.b = __ldg(reinterpret_cast<const uint4*>(p + 16));
  ch.tail = (threadIdx.x & 31) == 31 || rest <= kW;
  if (ch.tail) ch.c = __ldg(reinterpret_cast<const uint2*>(p + kW));
  return ch;
}

constexpr int kWords = kW / 4 + 2;  // text words of a thread: kW + 8 bytes

// v[i] = text bytes [j0 + i, j0 + i + 4) for i < kW + 4, little-endian.
// Every thread of the warp calls it (the overhang comes by a shuffle).
__device__ __forceinline__ void prefix_words(const Chunk& ch,
                                             uint32_t (&v)[kW + 4]) {
  uint32_t w[kWords];
  w[0] = ch.a.x; w[1] = ch.a.y; w[2] = ch.a.z; w[3] = ch.a.w;
  w[4] = ch.b.x; w[5] = ch.b.y; w[6] = ch.b.z; w[7] = ch.b.w;
  const uint32_t n0 = __shfl_down_sync(0xffffffffu, w[0], 1);
  const uint32_t n1 = __shfl_down_sync(0xffffffffu, w[1], 1);
  w[kW / 4] = ch.tail ? ch.c.x : n0;
  w[kW / 4 + 1] = ch.tail ? ch.c.y : n1;
#pragma unroll
  for (int i = 0; i < kW + 4; ++i) {
    const int q = i >> 2, s = (i & 3) * 8;
    v[i] = s == 0 ? w[q] : __funnelshift_r(w[q], w[q + 1], s);
  }
}

// Bit i set iff window i's 8-byte prefix equals the slot's under its mask.
// pre = {word lo, word hi, mask lo, mask hi}.
__device__ __forceinline__ uint32_t match_bits(const uint32_t (&v)[kW + 4],
                                               uint4 pre) {
  uint32_t bits = 0;
  if ((pre.z & pre.w) == 0xffffffffu) {  // m >= 8: uniform over the block
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      if (v[i] == pre.x && v[i + 4] == pre.y) bits |= 1u << i;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kW; ++i) {
      if ((((v[i] ^ pre.x) & pre.z) | ((v[i + 4] ^ pre.y) & pre.w)) == 0) {
        bits |= 1u << i;
      }
    }
  }
  return bits;
}

// Windows of `bits` (offsets from txt) whose bytes [8, m) also equal the
// slot's: the prefix test has already covered bytes [0, min(m, 8)).
__device__ __forceinline__ int count_tails(uint32_t bits, const uint8_t* txt,
                                           const uint8_t* slot, int m) {
  int c = 0;
  while (bits != 0) {
    const int i = __ffs(bits) - 1;
    bits &= bits - 1;
    const uint8_t* t = txt + i;
    int b = 8;
    while (b < m && t[b] == slot[b]) ++b;
    c += b >= m ? 1 : 0;
  }
  return c;
}

// Walks every item of the launch: `live(r)` gives row r's live windows
// (0 skips the row), `slots(ch, v, own)` tests this thread's windows
// against every slot (`own` masks its live windows), and `after(r)` runs
// once per item on the whole block (it may hold barriers). Rows
// [0, n_rows) of `rows` are walked; each holds `span` windows.
template <class Live, class Slots, class After>
__device__ __forceinline__ void walk(const uint8_t* rows, int64_t row_stride,
                                     int64_t n_rows, int64_t span, Live live,
                                     Slots slots, After after) {
  const int64_t seg = (int64_t)blockDim.x * kW;
  const int64_t segs = (span + seg - 1) / seg;
  const int64_t n_items = n_rows * segs;
  int64_t t = blockIdx.x;
  Chunk cur = fetch(rows, row_stride, segs, n_items, t, live);
  while (t < n_items) {  // uniform over the block
    const int64_t tn = t + gridDim.x;
    const Chunk nxt = fetch(rows, row_stride, segs, n_items, tn, live);
    uint32_t v[kW + 4];
    prefix_words(cur, v);
    if (cur.nown > 0) {
      const uint32_t own = cur.nown >= 32 ? 0xffffffffu : (1u << cur.nown) - 1u;
      slots(cur, v, own);
    }
    after(cur.r);
    cur = nxt;
    t = tn;
  }
}

}  // namespace exact
}  // namespace apm
