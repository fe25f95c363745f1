// Verdict-mask banded DP (TPU kernel #6), band and Myers modes.
//
// Replaces apm/ops/pallas_kernel.py::_scan_folded_pallas_mask (the mask
// mode of _scan_kernel_unrolled, both _band_phases and _myers_phases), the
// kernel Scanner.find runs on its hot rows. Contract of kernels A and C
// (dp_band.cu, dp_myers.cu): staged rows (R, wf + halo) uint8, window
// j = start + r*wf + lane (lane < wf) of row r, pattern p counts iff
// j < bound and its banded distance is <= k; besides the (P,) counts every
// window's verdict is stored as one byte of an (R, P, wf) mask at
// mask[r * mask_stride + p * wf + lane], zeros included (padding patterns
// and windows past the bound read 0).
//
// What bounds it on an H100: integer issue. A window costs m_p steps of
// 2k + 1 min-plus cells (band) or one bit-vector update (Myers) per
// pattern, against one byte read and P bytes written per window.
//
// Design: dp_pair.cuh's tile walk, two windows a thread (the paired 16-bit
// DPX band, the packed or two-chain Myers band), shared with kernels A and
// C; here each thread also stores its two verdicts as one 16-bit word, so
// a warp writes 64 contiguous bytes per pattern, and every tile, owned or
// not, writes its verdicts.
//
// Any k: the band kernel on the register path (ke = min(k, m_max) <=
// kRegMax) decides at kv = min(k, kCapMax - 2), so its 16-bit cells hold
// any k, as kernel A's count does (dp_band.cu). Past the cap, k >= 16383 >
// kRegMax, so ke = m_max <= 16 there: every live pattern has m <= 16 < kv,
// and D[m][m] <= m, so every owned window's verdict is 1 at kv and at k
// alike, mask and count. The pattern table keeps the caller's k: its rows
// are laid out for it (offset k - ke). The wide path (int32 cells) decides
// at k itself.
#include "dp_pair.cuh"

using namespace apm::pair;

namespace {

// Stores the verdict pair `hits` (bit 0: lane, bit 1: lane + 1) of one
// pattern; `v` points at the lane's byte of the pattern's mask line.
__device__ __forceinline__ void store_pair(const Args& a, uint8_t* v, int64_t lane,
                                           int hits) {
  if (a.pair_store) {
    if (lane < a.wf) *reinterpret_cast<uint16_t*>(v) = (uint16_t)((hits & 1) | ((hits >> 1) << 8));
  } else {
    if (lane < a.wf) v[0] = (uint8_t)(hits & 1);
    if (lane + 1 < a.wf) v[1] = (uint8_t)(hits >> 1);
  }
}

// ---------------------------------------------------------------- band mode

// KE >= 0: band pair in registers with half-width KE; KE < 0: wide band.
// STAGED: text and pattern table in shared memory; else read from global.
template <int KE, bool STAGED>
__global__ void __launch_bounds__(kThreads, band_blocks(KE)) band_mask_kernel(Args a) {
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

  const int64_t bound = a.dbound != nullptr ? *a.dbound : a.bound;
  const int kv = KE >= 0 ? min(a.k, kCapMax - 2) : a.k;  // the verdict's k (see above)
  const int64_t tpr = tiles_per_row(a);
  const int64_t n_tiles = a.n_rows * tpr;
  // Tile t needs text iff its first lane is owned.
  auto needed = [&](int64_t t) {
    const int64_t r = t / tpr;
    return (t - r * tpr) * kWin < apm::owned_limit(r, a.n_rows, a.wf, bound, a.start);
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
    const int64_t limit = apm::owned_limit(r, a.n_rows, a.wf, bound, a.start);
    const int64_t lane = lane0 + 2 * threadIdx.x;
    const int own = (lane < limit ? 1 : 0) | (lane + 1 < limit ? 2 : 0);
    uint8_t* vrow = a.mask + r * a.mask_stride + lane;
    for (int p = 0; p < a.n_pat; ++p) {
      const int m = s_plen[p];
      // Uniform: a padding slot, or a tile past the bound: zeros, no count.
      if (m <= 0 || m > a.m_max || lane0 >= limit) {
        store_pair(a, vrow + (int64_t)p * a.wf, lane, 0);
        continue;
      }
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
      store_pair(a, vrow + (int64_t)p * a.wf, lane, hits);
      apm::add_hits(s_cnt, p, (hits & 1) + (hits >> 1));
    }
    if constexpr (STAGED) {
      __syncthreads();  // every thread is done with this buffer
      buf ^= 1;
    }
  }
  if constexpr (STAGED) cp_async_wait_all();
  __syncthreads();
  apm::flush_counts(s_cnt, a.out, a.n_pat);
}

template <int KE, bool STAGED>
cudaError_t band_launch(const Args& a, int cap, cudaStream_t stream) {
  size_t smem = sizeof(int) * 2 * (size_t)a.n_pat;
  if (STAGED) {
    smem += sizeof(uint32_t) * ((size_t)a.n_pat * a.pat_stride + 2 * (size_t)a.stage_words);
  }
  int grid = 0;
  cudaError_t e = pair_grid(n_tiles(a), band_blocks(KE), cap, &grid);
  if (e == cudaSuccess) e = allow_smem(band_mask_kernel<KE, STAGED>, smem);
  if (e != cudaSuccess) return e;
  band_mask_kernel<KE, STAGED><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <int KE, bool STAGED>
cudaError_t band_dispatch(const Args& a, int cap, cudaStream_t stream) {
  if (a.ke == KE) return band_launch<KE, STAGED>(a, cap, stream);
  if constexpr (KE < kRegMax) {
    return band_dispatch<KE + 1, STAGED>(a, cap, stream);
  } else {
    return band_launch<-1, STAGED>(a, cap, stream);
  }
}

// ---------------------------------------------------------------- Myers mode

__global__ void __launch_bounds__(kThreads, kMyersBlocks) myers_mask_kernel(Args a) {
  extern __shared__ __align__(16) uint32_t smem[];
  const MyersSmem s = load_myers(a, smem);

  const int64_t bound = a.dbound != nullptr ? *a.dbound : a.bound;
  const int64_t tpr = tiles_per_row(a);
  const int64_t n_tiles = a.n_rows * tpr;
  for (int64_t t = blockIdx.x; t < n_tiles; t += gridDim.x) {
    const int64_t r = t / tpr;
    const int64_t lane0 = (t - r * tpr) * kWin;
    const int64_t limit = apm::owned_limit(r, a.n_rows, a.wf, bound, a.start);
    __syncthreads();  // the LUT (first tile), or every thread done with the last tile's text
    if (lane0 < limit) stage_channels(a, r, lane0, s);  // uniform
    __syncthreads();

    const int64_t lane = lane0 + 2 * threadIdx.x;
    const int own = (lane < limit ? 1 : 0) | (lane + 1 < limit ? 2 : 0);
    uint8_t* vrow = a.mask + r * a.mask_stride + lane;
    for (int p = 0; p < a.n_pat; ++p) {
      const int m = s.plen[p];
      if (m <= 0 || lane0 >= limit) {  // uniform, as in the band kernel
        store_pair(a, vrow + (int64_t)p * a.wf, lane, 0);
        continue;
      }
      const int hits = own != 0 ? myers_hits(a, s, p, m, own) : 0;
      store_pair(a, vrow + (int64_t)p * a.wf, lane, hits);
      apm::add_hits(s.cnt, p, (hits & 1) + (hits >> 1));
    }
  }
  __syncthreads();
  apm::flush_counts(s.cnt, a.out, a.n_pat);
}

bool bad_common(int64_t n_rows, int64_t row_stride, int n_pat, int m_max, int64_t wf,
                uint8_t* mask, int64_t mask_stride) {
  return n_rows <= 0 || n_pat <= 0 || m_max <= 0 || wf <= 0 || row_stride < wf + m_max - 1 ||
         mask == nullptr || mask_stride < n_pat * wf;
}

Args mask_args(const uint8_t* rows, int64_t n_rows, int64_t row_stride, int n_pat, int m_max,
               const int32_t* plens, int k, int64_t wf, int64_t bound, const int64_t* dbound,
               int64_t start, int32_t* out, uint8_t* mask, int64_t mask_stride) {
  Args a = base_args(rows, n_rows, row_stride, n_pat, m_max, plens, k, wf, bound, dbound, start,
                     out);
  a.mask = mask;
  a.mask_stride = mask_stride;
  a.pair_store = wf % 2 == 0 && (uintptr_t)mask % 2 == 0 && mask_stride % 2 == 0;
  return a;
}

}  // namespace

// Band mode: adds each pattern's window count to out[p] (the caller zeroes
// out) and stores every window's verdict at mask[r * mask_stride + p * wf +
// lane] (all n_rows * n_pat * wf cells are written). `dbound`, when not
// null, points at an int64 window bound in device memory that replaces
// `bound`. One launch: its grid is sized here; a positive `grid` caps it
// (wide bands, ke > 16, need `scratch` with room for grid * (2ke + 1) * 256
// int32). A table of n_pat * pat_stride 4-byte words within 32 KB is
// staged in shared memory with the text, a larger one read from global
// memory (the caller groups patterns to stay within it). Returns the
// launch's cudaError_t (0 on success).
extern "C" int apm_dp_band_mask(const uint8_t* rows, int64_t n_rows, int64_t row_stride,
                                const uint8_t* pat, int n_pat, int64_t pat_stride,
                                const int32_t* plens, int k, int ke, int64_t wf, int64_t bound,
                                const int64_t* dbound, int64_t start, int32_t* out,
                                uint8_t* mask, int64_t mask_stride, int32_t* scratch, int grid,
                                void* stream) {
  const int m_max = (int)(pat_stride - 2 * (int64_t)k);
  if (bad_common(n_rows, row_stride, n_pat, m_max, wf, mask, mask_stride) || k < 0 ||
      ke != std::min(k, m_max) ||
      (ke > kRegMax && (scratch == nullptr || grid <= 0))) {
    return (int)cudaErrorInvalidValue;
  }
  Args a = mask_args(rows, n_rows, row_stride, n_pat, m_max, plens, k, wf, bound, dbound,
                     start, out, mask, mask_stride);
  a.pat = pat;
  a.pat_stride = pat_stride;
  a.ke = ke;
  a.scratch = scratch;
  const bool staged = 4 * (int64_t)n_pat * pat_stride <= kTableBytes;
  return (int)(staged ? band_dispatch<0, true>(a, grid, (cudaStream_t)stream)
                      : band_dispatch<0, false>(a, grid, (cudaStream_t)stream));
}

// Myers mode: the same outputs by kernel C's bit-parallel band (1 <= k,
// 2k + 1 <= 29, k < m_max, 1 <= n_chan <= 32), the two windows of a thread
// packed into one word up to k = 7. One launch; its grid is sized here, at
// most `grid` blocks when `grid` is positive.
extern "C" int apm_dp_myers_mask(const uint8_t* rows, int64_t n_rows, int64_t row_stride,
                                 const int32_t* peq, int n_pat, int m_max, int n_chan,
                                 const uint8_t* alph, const int32_t* plens, int k, int64_t wf,
                                 int64_t bound, const int64_t* dbound, int64_t start,
                                 int32_t* out, uint8_t* mask, int64_t mask_stride, int grid,
                                 void* stream) {
  if (bad_common(n_rows, row_stride, n_pat, m_max, wf, mask, mask_stride) ||
      bad_myers(n_rows, n_pat, m_max, n_chan, k, wf)) {
    return (int)cudaErrorInvalidValue;
  }
  Args a = mask_args(rows, n_rows, row_stride, n_pat, m_max, plens, k, wf, bound, dbound,
                     start, out, mask, mask_stride);
  a.peq = peq;
  a.alph = alph;
  a.n_chan = n_chan;
  a.packed = 2 * k + 1 <= 15;
  const size_t smem = myers_smem(a);
  int g = 0;
  cudaError_t e = pair_grid(n_tiles(a), kMyersBlocks, grid, &g);
  if (e == cudaSuccess) e = allow_smem(myers_mask_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  myers_mask_kernel<<<g, kThreads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Blocks of the grid that a pair kernel launches over n_rows rows of wf
// windows with no cap: the band kernels of half-width ke (ke >= 0;
// apm_dp_band_mask, _count, _batch, _dyn) or the Myers kernels (ke < 0),
// or a negative cudaError_t. A wrapper sizes a wide band's scratch by it;
// a timer launches an empty kernel with it (apm_empty_launch, 256 threads
// a block) to read the launch floor.
extern "C" int apm_dp_mask_grid(int64_t n_rows, int64_t wf, int ke) {
  if (n_rows <= 0 || wf <= 0) return -(int)cudaErrorInvalidValue;
  int grid = 0;
  const cudaError_t e = pair_grid(n_rows * ((wf + kWin - 1) / kWin), blocks_per_sm(ke), 0, &grid);
  return e == cudaSuccess ? grid : -(int)e;
}
