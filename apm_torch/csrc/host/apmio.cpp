// apmio — native host layer of apm_torch: corpus I/O, staging, the EOF-tail
// verifier and the device-cache key.
//
// A copy of the JAX package's native/apmio.cpp with the same semantics,
// built by apm_torch/ops/_build.py::host_library (g++, at first use) and
// bound with ctypes in apm_torch/utils/native.py. It replaces the
// reference's host-side I/O layer (read_input_file, src/utils.c:12-68) with
// an mmap-backed whole-file loader and a halo-aware range reader, folds a
// corpus into the overlapping rows the kernels read, counts EOF-truncated
// windows, and hashes a corpus for the device corpus cache.
//
// Unlike the reference (open/lseek/read into malloc), we mmap readonly and
// memcpy into a caller-provided buffer so Python owns the memory (a numpy
// array or a page-locked tensor) and no allocation crosses the FFI boundary.

#include <cerrno>
#include <cstdint>
#include <cstring>
#include <thread>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

extern "C" {

// Returns the file size in bytes, or -1 on error.
int64_t apmio_file_size(const char* path) {
    struct stat st;
    if (stat(path, &st) != 0) return -1;
    return static_cast<int64_t>(st.st_size);
}

// Reads the whole file (raw bytes, newlines included) into `out`, which must
// hold at least `size` bytes (from apmio_file_size). Returns bytes read or -1.
int64_t apmio_read_file(const char* path, uint8_t* out, int64_t size) {
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -1;
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size < size) {
        close(fd);
        return -1;
    }
    if (size == 0) {
        close(fd);
        return 0;
    }
    void* p = mmap(nullptr, static_cast<size_t>(size), PROT_READ, MAP_PRIVATE, fd, 0);
    if (p == MAP_FAILED) {
        // Fallback: plain read loop (e.g. for special files).
        int64_t total = 0;
        while (total < size) {
            ssize_t r = read(fd, out + total, static_cast<size_t>(size - total));
            if (r <= 0) {
                close(fd);
                return -1;
            }
            total += r;
        }
        close(fd);
        return total;
    }
    memcpy(out, p, static_cast<size_t>(size));
    munmap(p, static_cast<size_t>(size));
    close(fd);
    return size;
}

// Reads the byte range [start, start+len) of the file into `out`, zero-filling
// any part past EOF. This is the multi-host shard feeder: each host slices its
// own overlapping (halo-extended) byte range without ever gathering the whole
// corpus (SURVEY.md §7 "Multi-host input feeding"). Returns 0 on success.
int32_t apmio_read_range(const char* path, int64_t start, int64_t len, uint8_t* out) {
    if (start < 0 || len < 0) return -1;
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -1;
    struct stat st;
    if (fstat(fd, &st) != 0) {
        close(fd);
        return -1;
    }
    const int64_t fsize = static_cast<int64_t>(st.st_size);
    int64_t avail = 0;
    if (start < fsize) avail = (start + len <= fsize) ? len : (fsize - start);
    if (avail > 0) {
        // Map page-aligned around the range.
        const int64_t page = static_cast<int64_t>(sysconf(_SC_PAGESIZE));
        const int64_t map_start = (start / page) * page;
        const int64_t map_len = (start - map_start) + avail;
        void* p = mmap(nullptr, static_cast<size_t>(map_len), PROT_READ, MAP_PRIVATE, fd,
                       static_cast<off_t>(map_start));
        if (p == MAP_FAILED) {
            close(fd);
            return -1;
        }
        memcpy(out, static_cast<uint8_t*>(p) + (start - map_start), static_cast<size_t>(avail));
        munmap(p, static_cast<size_t>(map_len));
    }
    if (avail < len) memset(out + avail, 0, static_cast<size_t>(len - avail));
    close(fd);
    return 0;
}

// Stages an in-memory corpus into the folded row layout the scan kernels
// consume: out row r = src[offset + r*wf, offset + r*wf + wf + halo),
// zero-filled past `src_len`. `out` must hold n_rows * (wf + halo) bytes.
// Faster than the NumPy strided-view + ascontiguouscopy (single pass of
// overlapping memcpys, no intermediate flat buffer). Returns 0 on success.
int32_t apmio_fold(const uint8_t* src, int64_t src_len, int64_t offset,
                   int64_t n_rows, int64_t wf, int64_t halo, uint8_t* out) {
    if (n_rows < 0 || wf <= 0 || halo < 0 || offset < 0) return -1;
    const int64_t wpf = wf + halo;
    for (int64_t r = 0; r < n_rows; ++r) {
        const int64_t lo = offset + r * wf;
        uint8_t* dst = out + r * wpf;
        int64_t avail = 0;
        if (lo < src_len) avail = (lo + wpf <= src_len) ? wpf : (src_len - lo);
        if (avail > 0) memcpy(dst, src + lo, static_cast<size_t>(avail));
        if (avail < wpf) memset(dst + avail, 0, static_cast<size_t>(wpf - avail));
    }
    return 0;
}

// Reads a folded-row staging block straight from the file (mmap + per-row
// memcpy): out row r = file[offset + r*wf, ... + wf + halo), zero-filled past
// EOF. Lets hosts stage chunks of corpora far larger than RAM would allow
// with a whole-file slurp. Returns 0 on success.
int32_t apmio_read_folded(const char* path, int64_t offset, int64_t n_rows,
                          int64_t wf, int64_t halo, uint8_t* out) {
    if (n_rows < 0 || wf <= 0 || halo < 0 || offset < 0) return -1;
    int fd = open(path, O_RDONLY);
    if (fd < 0) return -1;
    struct stat st;
    if (fstat(fd, &st) != 0) {
        close(fd);
        return -1;
    }
    const int64_t fsize = static_cast<int64_t>(st.st_size);
    const int64_t wpf = wf + halo;
    const int64_t want_end = offset + (n_rows > 0 ? (n_rows - 1) * wf + wpf : 0);
    const int64_t page = static_cast<int64_t>(sysconf(_SC_PAGESIZE));
    const int64_t map_start = (offset / page) * page;
    const int64_t map_end = want_end < fsize ? want_end : fsize;
    int32_t rc = 0;
    if (map_end > map_start) {
        const int64_t map_len = map_end - map_start;
        void* p = mmap(nullptr, static_cast<size_t>(map_len), PROT_READ,
                       MAP_PRIVATE, fd, static_cast<off_t>(map_start));
        if (p == MAP_FAILED) {
            close(fd);
            return -1;
        }
        rc = apmio_fold(static_cast<const uint8_t*>(p), map_len,
                        offset - map_start, n_rows, wf, halo, out);
        munmap(p, static_cast<size_t>(map_len));
    } else {
        memset(out, 0, static_cast<size_t>(n_rows * wpf));
    }
    close(fd);
    return rc;
}

// Banded Levenshtein window counter — the native host-side verifier.
// Counts window starts j in [0, n_windows) of `text` whose banded
// (|diag| <= k, clamped at k+1) Levenshtein distance to `pat` is <= k,
// with the reference's EOF prefix truncation semantics when
// `truncate_at >= 0` (size = min(m, truncate_at - j), matching
// sequential.c:131-134 where truncate_at = total bytes). Semantics match
// apm_torch.utils.oracle.banded_distances cell for cell. Used for the EOF
// tails and the bound-clipped rows (apm_torch/models/scanner.py,
// apm_torch/models/pipeline.py), where NumPy per-row overhead dominates.
int32_t apmio_banded_count(const uint8_t* text, int64_t text_len,
                           const uint8_t* pat, int64_t m, int64_t k,
                           int64_t n_windows, int64_t truncate_at,
                           int64_t* out_count) {
    if (m <= 0 || k < 0 || n_windows < 0) return -1;
    const int64_t bw = 2 * k + 1;
    const int32_t cap = static_cast<int32_t>(k + 1);
    // band[k + d] = D[x][x + d], clamped at cap.
    int32_t* band = new int32_t[bw];
    int32_t* nband = new int32_t[bw];
    int64_t count = 0;
    for (int64_t j = 0; j < n_windows; ++j) {
        int64_t size = m;
        if (truncate_at >= 0 && truncate_at - j < m) size = truncate_at - j;
        if (size <= 0) continue;
        for (int64_t d = -k; d <= k; ++d)
            band[k + d] = (d >= 0 && d <= size) ? static_cast<int32_t>(d < cap ? d : cap)
                                                : cap;
        int32_t res = cap;
        for (int64_t x = 1; x <= size; ++x) {
            int32_t prev = cap;  // insertion chain B_x[d-1]
            for (int64_t d = -k; d <= k; ++d) {
                const int64_t y = x + d;
                int32_t v;
                if (y < 0 || y > size) {
                    v = cap;
                } else if (y == 0) {
                    v = static_cast<int32_t>(x < cap ? x : cap);
                } else {
                    const int64_t ti = j + x - 1;
                    const uint8_t tc = (ti < text_len) ? text[ti] : 0;
                    const int32_t c = (pat[y - 1] == tc) ? 0 : 1;
                    v = band[k + d] + c;  // substitution
                    if (d < k) {
                        const int32_t del = band[k + d + 1] + 1;
                        if (del < v) v = del;
                    }
                    const int32_t ins = prev + 1;
                    if (ins < v) v = ins;
                    if (v > cap) v = cap;
                }
                nband[k + d] = v;
                prev = v;
            }
            int32_t* t = band;
            band = nband;
            nband = t;
            if (x == size) res = band[k];
        }
        if (res <= static_cast<int32_t>(k)) ++count;
    }
    delete[] band;
    delete[] nband;
    *out_count = count;
    return 0;
}

// apmio_banded_count for a whole pattern set over one text, in one call
// (one thread): pattern i is pats[offsets[i], offsets[i + 1]), its count
// goes to out[i]. The EOF tail of a scan (Scanner.suffix_counts) runs here
// on a host worker while the card scans: one call, so the worker takes the
// GIL once to enter and once to return, not once per pattern.
int32_t apmio_banded_count_set(const uint8_t* text, int64_t text_len,
                               const uint8_t* pats, const int64_t* offsets,
                               int64_t n_pats, int64_t k, int64_t n_windows,
                               int64_t truncate_at, int64_t* out) {
    if (n_pats < 0) return -1;
    for (int64_t i = 0; i < n_pats; ++i) {
        const int32_t rc = apmio_banded_count(text, text_len, pats + offsets[i],
                                              offsets[i + 1] - offsets[i], k,
                                              n_windows, truncate_at, out + i);
        if (rc != 0) return rc;
    }
    return 0;
}

// 64-bit content hash (MurmurHash64A mixing) for the device-corpus cache
// key. A *full* read of the buffer, so any in-place mutation changes the
// key (a sampled fingerprint could miss localized edits).
uint64_t apmio_hash(const uint8_t* buf, int64_t n) {
    const uint64_t m = 0xC6A4A7935BD1E995ull;
    uint64_t h = 0x9E3779B97F4A7C15ull ^ (static_cast<uint64_t>(n) * m);
    int64_t i = 0;
    for (; i + 8 <= n; i += 8) {
        uint64_t w;
        memcpy(&w, buf + i, 8);
        w *= m;
        w ^= w >> 47;
        w *= m;
        h ^= w;
        h *= m;
    }
    uint64_t tail = 0;
    for (int64_t j = 0; i + j < n; ++j) {
        tail |= static_cast<uint64_t>(buf[i + j]) << (8 * j);
    }
    h ^= tail;
    h *= m;
    h ^= h >> 47;
    h *= m;
    h ^= h >> 47;
    return h;
}

// Parallel variant: the hash sits on the critical path of every cached
// scan (the key must be computed before the device cache can be probed),
// and a single Murmur stream is bound by one core. Hash disjoint stripes
// on threads and mix the stripe digests
// (order-dependent combine keeps the digest sensitive to stripe order).
uint64_t apmio_hash_par(const uint8_t* buf, int64_t n, int32_t threads) {
    const int64_t kMinStripe = 8 << 20;  // threading pays only for big bufs
    int32_t t = threads > 0 ? threads : 1;
    if (t > 16) t = 16;
    int64_t n_stripes = (n + kMinStripe - 1) / kMinStripe;
    if (n_stripes < t) t = static_cast<int32_t>(n_stripes);
    if (t <= 1) return apmio_hash(buf, n);

    uint64_t digests[16];
    std::thread workers[16];
    const int64_t stripe = (n + t - 1) / t;
    for (int32_t i = 0; i < t; ++i) {
        const int64_t lo = i * stripe;
        const int64_t hi = (lo + stripe < n) ? lo + stripe : n;
        workers[i] = std::thread([buf, lo, hi, i, &digests]() {
            digests[i] = apmio_hash(buf + lo, hi - lo);
        });
    }
    const uint64_t m = 0xC6A4A7935BD1E995ull;
    uint64_t h = 0xA0761D6478BD642Full ^ (static_cast<uint64_t>(n) * m);
    for (int32_t i = 0; i < t; ++i) {
        workers[i].join();
        h ^= digests[i];
        h *= m;
        h ^= h >> 47;
    }
    return h;
}

}  // extern "C"
