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
// What bounds it on an H100: integer throughput, about 20 operations per step
// per pattern whatever k is (kernel A pays about 7 per band cell, 2k + 1
// cells), plus one shared-memory load of the match word.
//
// Design: the TPU kernel keeps VP/VN as (fold, wf) int32 tiles and the PEQ
// words as SMEM scalars selected per alphabet channel. Here one thread
// scans one window and keeps VP, VN and the centre value in registers; the
// whole PEQ table (at most 64 KB under apm's gate) is copied into shared
// memory once per block, and a 256-entry byte -> channel table in shared
// memory replaces the per-channel compare chain: one lookup and one load
// give the match word, and a byte outside the alphabet gives 0. Ownership
// and counting are kernel A's (apm::owned_limit, shared per-pattern
// counters). The window bound is a value or, for phase-2 verification,
// read from device memory.
//
// The batch mode (apm_dp_myers_batch, _scan_folded_pallas_batch in Myers
// mode) is kernel A's (dp_band.cu): per-block [bound, start] pairs with an
// (R/8, P) count output. The mask mode (apm_dp_myers_mask,
// _scan_folded_pallas_mask in Myers mode, TPU kernel #6) is a kernel of
// its own in dp_mask.cu.
#include "scan_common.cuh"

namespace {

using apm::kTile;

constexpr int kMaxBits = 29;  // 2k + 1 for apm's MYERS_KMAX = 14
constexpr int kNoChannel = 255;

struct MyersArgs {
  const uint8_t* rows;  // (n_rows, row_stride) staged corpus rows
  int64_t n_rows;
  int64_t row_stride;   // wf + halo
  const int32_t* peq;   // (n_pat * m_max, n_chan) match words
  int n_pat;
  int m_max;
  int n_chan;           // alphabet size C (<= 8 under apm's gate)
  const uint8_t* alph;  // (n_chan,) distinct pattern bytes
  const int32_t* plens; // (n_pat,) pattern lengths, 0 = padding slot
  int k;
  int64_t wf;
  int64_t bound;
  const int64_t* dbound;  // optional device-side bound (overrides bound)
  int64_t start;
  int32_t* out;         // (n_pat,) counts, accumulated with atomics
  const int32_t* meta;  // batch mode: (n_rows / 8, 2) [bound, start]
  int64_t out_stride;   // batch mode: slot b of the counts at out + b*stride
};

struct BitBand {
  uint32_t vp, vn;
  int cc;
};

__device__ __forceinline__ void bit_step(BitBand& s, uint32_t eq,
                                         uint32_t mask, int cbit) {
  const uint32_t xv = eq | s.vn;
  const uint32_t xh = (((eq & s.vp) + s.vp) ^ s.vp) | eq;
  uint32_t ph = s.vn | (~(xh | s.vp) & mask);
  uint32_t mh = s.vp & xh;
  ph = ((ph << 1) & mask) | 1u;  // horizontal carry-in = +1
  mh = (mh << 1) & mask;
  s.cc += 1 - (int)(((xh | s.vn) >> cbit) & 1u);
  s.vp = mh | (~(xv | ph) & mask);
  s.vn = ph & xv;
}

// Verdict centre <= k for one window. `txt` points at the window's first
// text byte, `peq` at this pattern's first PEQ row in shared memory.
__device__ __forceinline__ int verdict_myers(const uint8_t* __restrict__ txt,
                                             const int32_t* peq,
                                             const uint8_t* chan, int n_chan,
                                             int m, int k) {
  const int bw = 2 * k + 1;
  const uint32_t mask = (1u << bw) - 1u;
  const uint32_t topbit = 1u << (bw - 1);
  BitBand s{mask, 0u, 0};
  const int xs = m < k ? m : k;
  const int32_t* row_k = peq + k * n_chan;
  for (int x = 1; x <= xs; ++x) {
    const int c = chan[txt[x - 1]];
    const uint32_t eq = c == kNoChannel ? 0u : (uint32_t)row_k[c];
    bit_step(s, eq, mask, x - 1);
  }
  if (m > k) {
    s.vp = ((s.vp << 1) | 1u) & mask;
    s.vn = (s.vn << 1) & mask;
    for (int x = k + 1; x <= m; ++x) {
      s.vp = (s.vp >> 1) | topbit;
      s.vn >>= 1;
      const int c = chan[txt[x - 1]];
      const uint32_t eq =
          c == kNoChannel ? 0u : (uint32_t)peq[(x - 1) * n_chan + c];
      bit_step(s, eq, mask, k);
    }
  }
  return s.cc <= k ? 1 : 0;
}

__global__ void __launch_bounds__(kTile) dp_myers_kernel(MyersArgs a) {
  extern __shared__ int smem[];
  int* s_cnt = smem;                           // (n_pat,)
  int32_t* s_peq = smem + a.n_pat;             // (n_pat * m_max * n_chan,)
  const int n_words = a.n_pat * a.m_max * a.n_chan;
  uint8_t* s_chan = reinterpret_cast<uint8_t*>(s_peq + n_words);  // (256,)

  apm::zero_counts(s_cnt, a.n_pat);
  for (int i = threadIdx.x; i < n_words; i += blockDim.x) s_peq[i] = a.peq[i];
  for (int i = threadIdx.x; i < 256; i += blockDim.x) s_chan[i] = kNoChannel;
  __syncthreads();
  if (threadIdx.x < a.n_chan) s_chan[a.alph[threadIdx.x]] = threadIdx.x;
  __syncthreads();

  const int64_t bound = a.dbound != nullptr ? *a.dbound : a.bound;
  const int64_t tiles_per_row = (a.wf + kTile - 1) / kTile;
  const int64_t n_tiles = a.n_rows * tiles_per_row;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t r = t / tiles_per_row;
    const int64_t lane0 = (t - r * tiles_per_row) * kTile;
    const int64_t limit =
        a.meta != nullptr ? apm::batch_limit(a.meta, r, a.wf)
                          : apm::owned_limit(r, a.n_rows, a.wf, bound, a.start);
    if (lane0 >= limit) continue;  // uniform over the block
    const int64_t lane = lane0 + threadIdx.x;
    const bool own = lane < limit;
    const uint8_t* txt = a.rows + r * a.row_stride + lane;
    for (int p = 0; p < a.n_pat; ++p) {
      const int m = a.plens[p];
      if (m <= 0) continue;  // padding slot: no work
      int hit = 0;
      if (own) {
        hit = verdict_myers(txt, s_peq + (int64_t)p * a.m_max * a.n_chan,
                            s_chan, a.n_chan, m, a.k);
      }
      apm::add_hits(s_cnt, p, hit);
    }
    if (a.meta != nullptr) {
      __syncthreads();
      apm::flush_and_reset(s_cnt, a.out + (r / apm::kFold) * a.out_stride,
                           a.n_pat);
      __syncthreads();
    }
  }
  if (a.meta == nullptr) {
    __syncthreads();
    apm::flush_counts(s_cnt, a.out, a.n_pat);
  }
}

int run(const MyersArgs& a, int grid, void* stream) {
  if (grid <= 0 || a.n_pat <= 0 || a.k < 1 || 2 * a.k + 1 > kMaxBits ||
      a.k >= a.m_max || a.n_chan < 1 || a.n_chan > 32) {
    return (int)cudaErrorInvalidValue;
  }
  const size_t smem = sizeof(int) * ((size_t)a.n_pat +
                                     (size_t)a.n_pat * a.m_max * a.n_chan) +
                      256;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        dp_myers_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dp_myers_kernel<<<grid, kTile, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// Adds each pattern's window count to out[p] (the caller zeroes out).
// `dbound`, when not null, points at an int64 window bound in device memory
// that replaces `bound`. Returns the launch's cudaError_t (0 on success).
extern "C" int apm_dp_myers_count(const uint8_t* rows, int64_t n_rows,
                                  int64_t row_stride, const int32_t* peq,
                                  int n_pat, int m_max, int n_chan,
                                  const uint8_t* alph, const int32_t* plens,
                                  int k, int64_t wf, int64_t bound,
                                  const int64_t* dbound, int64_t start,
                                  int32_t* out, int grid, void* stream) {
  const MyersArgs a{rows,  n_rows, row_stride, peq,    n_pat,   m_max,
                    n_chan, alph,  plens,      k,      wf,      bound,
                    dbound, start, out,        nullptr, 0};
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
  const MyersArgs a{rows,  n_rows, row_stride, peq,  n_pat,      m_max,
                    n_chan, alph,  plens,      k,    wf,         0,
                    nullptr, 0,    out,        meta, out_stride};
  return run(a, grid, stream);
}
