// Exact-match (k = 0) window count (kernel B).
//
// Replaces apm/ops/corr_fused.py::scan_corr_fused (kernel body
// _fused_kernel). Same contract: staged rows (R, wf + halo) uint8, the
// global window bound and start, n_rows; row r < n_rows owns lanes
// [0, clip(bound - start - r*wf, 0, wf)), and an owned window j counts for
// pattern slot p iff the text at j equals pattern p over all m_p bytes.
// That is exactly what the TPU kernel's certificate corr >= B * m_p states:
// bytes outside the pattern alphabet encode to zero planes there and can
// never reach the threshold, and the pattern bytes are the alphabet.
// Sentinel slots (threshold 2^30 on the TPU) arrive here with m_p = 0 and
// never count. The pattern bytes, and each slot's 8-byte prefix word and
// mask, are decoded on the host from the TPU tables (km, thr, alphabet), so
// loaded tables drive this kernel too.
//
// What bounds it on an H100: at a few patterns, reading the staged rows
// once (a 256 MB chunk: 0.08 ms at 3.35 TB/s) and the instructions around
// each test (loads, prefix words, the slot loop), which a design of one
// thread per window, a byte compare chain and a warp reduction per window
// and pattern left at 2.8 % of the byte bound; at tens of patterns, the
// integer compares, since every window is tested against every slot (at
// P = 64 the loop over slots sets the time, 13-15 times P = 2's).
//
// Design (exact_scan.cuh): each thread owns 32 consecutive windows, read
// with two 16-byte loads (the next item's loads in flight during this
// item's compares); a window's 8-byte prefix is built from registers with
// funnel shifts and tested against each slot's prefix word in three
// instructions; only a prefix match reads the slot's remaining bytes; hits
// are summed per slot in a register and reach the block's shared counter
// only when nonzero, and the block's counters reach out[] with one atomic
// per nonzero (block, pattern). The slots' prefix words, masks and lengths
// sit in shared memory, loaded once per block; a launch holds up to 8192
// slots (the wrapper's group), 24 bytes each. Staging padding (rows at or
// past n_rows, windows past the bound) is masked by ownership, which keeps
// a NUL byte in the alphabet exact.
//
// Batch mode (kernel #8, apm_corr_batch_count) replaces
// apm/ops/corr_fused.py::scan_corr_batch_fused (kernel body
// _fused_batch_kernel): rows of many corpora, each row's ownership given as
// limits[r] (its owned lanes, precomputed by the caller from the corpus's
// bound), counts per block of `fold` rows into an (R/fold, max(P, p_out))
// output. It runs the count mode's design on exact_scan.cuh with
// live(r) = clip(limits[r], 0, wf), and credits a thread's nonzero count
// of a slot straight to the row block's output with one global atomic:
// hits are rare (every window of all-A text against A^m is the exception),
// so no shared counter, barrier or flush per item is needed. The TPU kernel
// instead folds per-128-byte chunks with an owner matmul and sums them
// outside the kernel. A batch group (1024 rows, 8.5 MB) is read once in
// 2.5 us at 3.35 TB/s, below the cost of a launch: at that size the
// launch, not HBM or the compares, bounds it (chip_smoke.py phase 3c times
// an empty launch beside it). A design of one thread per window with a
// byte compare chain and a barrier and flush after every 256-window tile
// took 0.13-0.21 ms a group.
#include "exact_scan.cuh"
#include "scan_common.cuh"

namespace {

namespace ex = apm::exact;

struct CountArgs {
  const uint8_t* rows;  // (n_staged, row_stride) staged corpus rows
  int64_t n_staged;
  int64_t row_stride;   // wf + halo, a multiple of 16
  int64_t n_rows;       // rows carrying real windows
  const uint8_t* pat;   // (n_pat, pat_stride) pattern bytes
  int64_t pat_stride;
  const uint4* prefix;  // (n_pat,) prefix word lo, hi, mask lo, hi
  const int32_t* plens; // (n_pat,) pattern lengths, 0 = sentinel slot
  int n_pat;
  int64_t wf;
  int64_t bound;
  int64_t start;
  int32_t* out;         // (n_pat,) counts, accumulated with atomics
};

// 2 blocks an SM (ops/corr_fused.py's _EXACT_BLOCKS_PER_SM sizes the grid
// to match).
__global__ void __launch_bounds__(ex::kMaxThreads, 2)
    corr_count_kernel(CountArgs a) {
  extern __shared__ uint4 smem4[];
  uint4* s_pre = smem4;                                       // (n_pat,)
  int* s_cnt = reinterpret_cast<int*>(s_pre + a.n_pat);       // (n_pat,)
  int* s_len = s_cnt + a.n_pat;                               // (n_pat,)
  for (int i = threadIdx.x; i < a.n_pat; i += blockDim.x) {
    s_pre[i] = a.prefix[i];
    s_len[i] = a.plens[i];
    s_cnt[i] = 0;
  }
  __syncthreads();

  const int64_t rows = a.n_rows < a.n_staged ? a.n_rows : a.n_staged;
  auto live = [=](int64_t r) {
    return apm::owned_limit(r, a.n_rows, a.wf, a.bound, a.start);
  };
  auto slots = [=](const ex::Chunk& ch, const uint32_t (&v)[ex::kW + 4],
                   uint32_t own) {
    const uint8_t* txt = a.rows + ch.r * a.row_stride + ch.j0;
    for (int p = 0; p < a.n_pat; ++p) {
      const int m = s_len[p];
      if (m <= 0) continue;  // sentinel slot: uniform over the block
      const uint32_t bits = ex::match_bits(v, s_pre[p]) & own;
      if (bits != 0) {
        const int c = ex::count_tails(bits, txt, a.pat + p * a.pat_stride, m);
        if (c != 0) atomicAdd(&s_cnt[p], c);
      }
    }
  };
  ex::walk(a.rows, a.row_stride, rows, a.wf, live, slots, [](int64_t) {});
  __syncthreads();
  apm::flush_counts(s_cnt, a.out, a.n_pat);
}

struct BatchArgs {
  const uint8_t* rows;  // (n_staged, row_stride) staged corpus rows
  int64_t n_staged;
  int64_t row_stride;   // wf + halo, a multiple of 16
  const uint8_t* pat;   // (n_pat, pat_stride) pattern bytes
  int64_t pat_stride;
  const uint4* prefix;  // (n_pat,) prefix word lo, hi, mask lo, hi
  const int32_t* plens; // (n_pat,) pattern lengths, 0 = sentinel slot
  int n_pat;
  int64_t wf;
  const int32_t* limits;  // (n_staged,) owned lanes per row
  int fold;             // rows per count slot
  int64_t out_stride;   // slot b of the counts at out + b*stride
  int32_t* out;
};

// 2 blocks an SM, like the count mode (_EXACT_BLOCKS_PER_SM).
__global__ void __launch_bounds__(ex::kMaxThreads, 2)
    corr_batch_kernel(BatchArgs a) {
  extern __shared__ uint4 smem4[];
  uint4* s_pre = smem4;                                  // (n_pat,)
  int* s_len = reinterpret_cast<int*>(s_pre + a.n_pat);  // (n_pat,)
  for (int i = threadIdx.x; i < a.n_pat; i += blockDim.x) {
    s_pre[i] = a.prefix[i];
    s_len[i] = a.plens[i];
  }
  __syncthreads();

  auto live = [=](int64_t r) { return apm::clip_lanes(a.limits[r], a.wf); };
  auto slots = [=](const ex::Chunk& ch, const uint32_t (&v)[ex::kW + 4],
                   uint32_t own) {
    const uint8_t* txt = a.rows + ch.r * a.row_stride + ch.j0;
    int32_t* out = a.out + (ch.r / a.fold) * a.out_stride;
    for (int p = 0; p < a.n_pat; ++p) {
      const int m = s_len[p];
      if (m <= 0) continue;  // sentinel slot: uniform over the block
      const uint32_t bits = ex::match_bits(v, s_pre[p]) & own;
      if (bits != 0) {
        const int c = ex::count_tails(bits, txt, a.pat + p * a.pat_stride, m);
        if (c != 0) atomicAdd(&out[p], c);
      }
    }
  };
  ex::walk(a.rows, a.row_stride, a.n_staged, a.wf, live, slots, [](int64_t) {});
}

__global__ void empty_kernel() {}

}  // namespace

// Adds each slot's exact-match count to out[p] (the caller zeroes out).
// rows and row_stride must be multiples of 16 bytes, prefix 16-byte
// aligned; `grid` blocks walk the rows grid-stride. Returns the launch's
// cudaError_t (0 on success).
extern "C" int apm_corr_fused_count(const uint8_t* rows, int64_t n_staged,
                                    int64_t row_stride, int64_t n_rows,
                                    const uint8_t* pat, int n_pat,
                                    int64_t pat_stride, const int32_t* plens,
                                    const void* prefix, int64_t wf,
                                    int64_t bound, int64_t start, int32_t* out,
                                    int grid, void* stream) {
  if (grid <= 0 || n_pat <= 0 || wf <= 0 || (uintptr_t)rows % 16 != 0 ||
      row_stride % 16 != 0 || (uintptr_t)prefix % 16 != 0 ||
      row_stride < wf + ex::kW + 8) {
    return (int)cudaErrorInvalidValue;
  }
  const CountArgs a{rows,  n_staged, row_stride, n_rows,
                    pat,   pat_stride, static_cast<const uint4*>(prefix),
                    plens, n_pat,    wf,         bound, start, out};
  const size_t smem = (size_t)n_pat * (sizeof(uint4) + 2 * sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        corr_count_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  corr_count_kernel<<<grid, ex::threads_for(wf), smem,
                      (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// Batch mode: row r owns lanes [0, limits[r]) and its counts are added to
// out[(r / fold) * out_stride + p]; n_staged is a multiple of fold and the
// caller zeroes out. rows and row_stride must be multiples of 16 bytes,
// prefix 16-byte aligned.
extern "C" int apm_corr_batch_count(const uint8_t* rows, int64_t n_staged,
                                    int64_t row_stride, const uint8_t* pat,
                                    int n_pat, int64_t pat_stride,
                                    const int32_t* plens, const void* prefix,
                                    int64_t wf, const int32_t* limits, int fold,
                                    int32_t* out, int64_t out_stride,
                                    int grid, void* stream) {
  if (grid <= 0 || n_pat <= 0 || wf <= 0 || limits == nullptr || fold <= 0 ||
      n_staged % fold != 0 || out_stride < n_pat || (uintptr_t)rows % 16 != 0 ||
      row_stride % 16 != 0 || (uintptr_t)prefix % 16 != 0 ||
      row_stride < wf + ex::kW + 8) {
    return (int)cudaErrorInvalidValue;
  }
  const BatchArgs a{rows,  n_staged, row_stride, pat, pat_stride,
                    static_cast<const uint4*>(prefix), plens, n_pat, wf,
                    limits, fold, out_stride, out};
  const size_t smem = (size_t)n_pat * (sizeof(uint4) + sizeof(int));
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        corr_batch_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  corr_batch_kernel<<<grid, ex::threads_for(wf), smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

// A kernel that does nothing, launched with `grid` blocks of `threads`
// (the grid and block of the kernel being timed, kernel #8's or the mask
// kernels'): what a launch alone costs.
extern "C" int apm_empty_launch(int grid, int threads, void* stream) {
  if (grid <= 0 || threads <= 0 || threads > 1024) return (int)cudaErrorInvalidValue;
  empty_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
