// tpurec_torch's native CSV loader: the port's own copy of the JAX
// package's tpurec/native/csv_loader.cpp, built by tpurec_torch/native/build.py.
//
// The reference tensorizes its preprocessed all-integer CSVs through pandas
// and caches torch tensors (the reference's run.py:194-218).  At Ali-CCP
// scale (~85M rows x 26 int columns) that path is minutes of single-threaded
// Python; this loader mmaps the file and parses integer fields with all
// cores, feeding the framework's columnar int32 cache directly.
//
// Exposed as a plain C ABI for ctypes (no pybind11 in the image):
//   trc_count_rows(path, &n_rows, &n_cols, &header_len) -> 0 on success
//   trc_parse_i32(path, out, n_rows, n_cols, skip_bytes, n_threads)
//       -> number of malformed/overflowed fields (0 == clean parse)
//
// Dialect: comma-separated, '\n' line ends (trailing '\r' stripped), one
// optional header line, integer fields with optional leading '-'.  Empty
// fields parse as 0 (pandas NaN-free int frames never emit them; tolerated
// for robustness).

#include <atomic>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <thread>
#include <vector>

#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

struct MappedFile {
  const char* data = nullptr;
  size_t size = 0;
  int fd = -1;

  bool open(const char* path) {
    fd = ::open(path, O_RDONLY);
    if (fd < 0) return false;
    struct stat st;
    if (fstat(fd, &st) != 0 || st.st_size == 0) {
      ::close(fd);
      fd = -1;
      return false;
    }
    size = static_cast<size_t>(st.st_size);
    void* p = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
    if (p == MAP_FAILED) {
      ::close(fd);
      fd = -1;
      return false;
    }
    data = static_cast<const char*>(p);
    madvise(p, size, MADV_SEQUENTIAL);
    return true;
  }

  ~MappedFile() {
    if (data) munmap(const_cast<char*>(data), size);
    if (fd >= 0) ::close(fd);
  }
};

// Parse one line of n_cols comma-separated ints into out.  Returns the
// number of bad fields encountered (parse continues on errors, writing 0).
inline int parse_line(const char* p, const char* line_end, int32_t* out,
                      int64_t n_cols) {
  int bad = 0;
  for (int64_t c = 0; c < n_cols; ++c) {
    bool neg = false;
    if (p < line_end && *p == '-') {
      neg = true;
      ++p;
    }
    int64_t v = 0;
    bool any = false, overflow = false;
    while (p < line_end && *p != ',') {
      char ch = *p;
      if (ch == '\r') {
        ++p;
        continue;
      }
      if (ch < '0' || ch > '9') {
        ++bad;
        // skip the rest of the field
        while (p < line_end && *p != ',') ++p;
        any = true;
        v = 0;
        break;
      }
      v = v * 10 + (ch - '0');
      if (v > INT32_MAX) overflow = true;
      any = true;
      ++p;
    }
    if (overflow) {
      ++bad;
      v = 0;
    }
    (void)any;
    out[c] = static_cast<int32_t>(neg ? -v : v);
    if (c + 1 < n_cols) {
      if (p < line_end && *p == ',') {
        ++p;
      } else {
        ++bad;  // short row: remaining columns become 0
        for (int64_t r = c + 1; r < n_cols; ++r) out[r] = 0;
        return bad;
      }
    }
  }
  return bad;
}

}  // namespace

extern "C" {

// Scan the file once: number of data rows (non-empty lines after the
// header), number of columns on the first line, and the byte offset of the
// first data row when skip_header != 0.
int trc_count_rows(const char* path, int skip_header, int64_t* n_rows,
                   int64_t* n_cols, int64_t* data_offset) {
  MappedFile f;
  if (!f.open(path)) return -1;
  const char* p = f.data;
  const char* end = f.data + f.size;

  // columns from the first line
  int64_t cols = 1;
  const char* q = p;
  while (q < end && *q != '\n') {
    if (*q == ',') ++cols;
    ++q;
  }
  *n_cols = cols;

  const char* data_start = p;
  if (skip_header) data_start = (q < end) ? q + 1 : end;
  *data_offset = data_start - f.data;

  // count newlines from data_start (memchr is vectorized)
  int64_t rows = 0;
  const char* s = data_start;
  while (s < end) {
    const char* nl = static_cast<const char*>(memchr(s, '\n', end - s));
    if (!nl) {
      if (end - s > 0) ++rows;  // final line without trailing newline
      break;
    }
    if (nl > s) ++rows;  // skip empty lines
    s = nl + 1;
  }
  *n_rows = rows;
  return 0;
}

// Parse the integer CSV body into out[n_rows * n_cols] (row-major int32).
// Returns total bad-field count (>=0), or -1 on IO error, -2 if the file
// has a different number of rows than n_rows.
int64_t trc_parse_i32(const char* path, int32_t* out, int64_t n_rows,
                      int64_t n_cols, int64_t data_offset, int n_threads) {
  MappedFile f;
  if (!f.open(path)) return -1;
  const char* base = f.data + data_offset;
  const char* end = f.data + f.size;
  if (base > end) return -1;

  if (n_threads <= 0) {
    n_threads = static_cast<int>(std::thread::hardware_concurrency());
    if (n_threads <= 0) n_threads = 1;
  }
  if (n_threads > 64) n_threads = 64;

  // Split the byte range into n_threads chunks aligned to line starts.
  size_t body = end - base;
  std::vector<const char*> starts(n_threads + 1);
  starts[0] = base;
  for (int t = 1; t < n_threads; ++t) {
    const char* guess = base + body * t / n_threads;
    const char* nl =
        static_cast<const char*>(memchr(guess, '\n', end - guess));
    starts[t] = nl ? nl + 1 : end;
  }
  starts[n_threads] = end;

  // Pass 1 (parallel): rows per chunk, so each thread knows its output slot.
  std::vector<int64_t> chunk_rows(n_threads, 0);
  {
    std::vector<std::thread> ths;
    for (int t = 0; t < n_threads; ++t) {
      ths.emplace_back([&, t] {
        int64_t rows = 0;
        const char* s = starts[t];
        const char* e = starts[t + 1];
        while (s < e) {
          const char* nl = static_cast<const char*>(memchr(s, '\n', e - s));
          if (!nl) {
            if (e - s > 0) ++rows;
            break;
          }
          if (nl > s) ++rows;
          s = nl + 1;
        }
        chunk_rows[t] = rows;
      });
    }
    for (auto& th : ths) th.join();
  }
  std::vector<int64_t> row_offset(n_threads + 1, 0);
  for (int t = 0; t < n_threads; ++t)
    row_offset[t + 1] = row_offset[t] + chunk_rows[t];
  if (row_offset[n_threads] != n_rows) return -2;

  // Pass 2 (parallel): parse.
  std::atomic<int64_t> bad_total{0};
  {
    std::vector<std::thread> ths;
    for (int t = 0; t < n_threads; ++t) {
      ths.emplace_back([&, t] {
        int64_t bad = 0;
        int64_t row = row_offset[t];
        const char* s = starts[t];
        const char* e = starts[t + 1];
        while (s < e) {
          const char* nl = static_cast<const char*>(memchr(s, '\n', e - s));
          const char* line_end = nl ? nl : e;
          if (line_end > s) {
            bad += parse_line(s, line_end, out + row * n_cols, n_cols);
            ++row;
          }
          if (!nl) break;
          s = nl + 1;
        }
        bad_total.fetch_add(bad, std::memory_order_relaxed);
      });
    }
    for (auto& th : ths) th.join();
  }
  return bad_total.load();
}

}  // extern "C"
