// Native data loader: mmap'd single-pass CSV -> packed column arrays.
//
// The port's own copy of the JAX package's native/csv_loader.cc. It parses
// the reference on-disk layout (domain_i/{train,val,test}.csv with header
// uid,pid,domain,label — reference dataset/Amazon/split.py:20): the file is
// mmapped and all four int/float columns are parsed in one pass with no
// allocation per row. Bound through ctypes by
// mamdr_tpu_torch/data/native_loader.py, which builds it at first use.
//
// API (C linkage):
//   int64 csv_count_rows(const char* path)
//       -> number of data rows (excluding header), or -1 on error.
//   int64 csv_load(const char* path, int32* uid, int32* pid, int32* domain,
//                  float* label, int64 capacity)
//       -> rows written, or -1 on error / malformed row / capacity overflow.
//
// Build: g++ -O3 -std=c++17 -fPIC -shared csv_loader.cc -o libcsvloader.so

#include <cstdint>
#include <cstdio>
#include <cstring>

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
      return st.st_size == 0;  // empty file: valid, zero rows
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

// Parse a non-negative integer field; advances *p past the delimiter.
// Returns false on malformed input.
inline bool parse_i32(const char*& p, const char* end, char delim, int32_t* out) {
  int64_t v = 0;
  bool any = false;
  while (p < end && *p >= '0' && *p <= '9') {
    v = v * 10 + (*p - '0');
    any = true;
    ++p;
  }
  if (!any || v > INT32_MAX) return false;
  if (p < end && *p == delim) ++p;
  *out = static_cast<int32_t>(v);
  return true;
}

// Parse a float field of the restricted form [-]ddd[.ddd]; advances past
// newline (handles \r\n). Labels in this format are 0/1 (or scores).
inline bool parse_f32_to_eol(const char*& p, const char* end, float* out) {
  bool neg = false;
  if (p < end && *p == '-') {
    neg = true;
    ++p;
  }
  double v = 0;
  bool any = false;
  while (p < end && *p >= '0' && *p <= '9') {
    v = v * 10 + (*p - '0');
    any = true;
    ++p;
  }
  if (p < end && *p == '.') {
    ++p;
    double scale = 0.1;
    while (p < end && *p >= '0' && *p <= '9') {
      v += (*p - '0') * scale;
      scale *= 0.1;
      any = true;
      ++p;
    }
  }
  if (!any) return false;
  if (p < end && *p == '\r') ++p;
  if (p < end && *p == '\n') ++p;
  *out = static_cast<float>(neg ? -v : v);
  return true;
}

inline const char* skip_line(const char* p, const char* end) {
  const char* nl = static_cast<const char*>(memchr(p, '\n', end - p));
  return nl ? nl + 1 : end;
}

}  // namespace

extern "C" {

int64_t csv_count_rows(const char* path) {
  MappedFile f;
  if (!f.open(path)) return -1;
  if (f.size == 0) return 0;
  const char* p = f.data;
  const char* end = f.data + f.size;
  p = skip_line(p, end);  // header
  int64_t rows = 0;
  while (p < end) {
    p = skip_line(p, end);
    ++rows;
  }
  return rows;
}

int64_t csv_load(const char* path, int32_t* uid, int32_t* pid, int32_t* domain,
                 float* label, int64_t capacity) {
  MappedFile f;
  if (!f.open(path)) return -1;
  if (f.size == 0) return 0;
  const char* p = f.data;
  const char* end = f.data + f.size;
  p = skip_line(p, end);  // header
  int64_t n = 0;
  while (p < end) {
    if (*p == '\n') {  // tolerate blank lines
      ++p;
      continue;
    }
    if (n >= capacity) return -1;
    if (!parse_i32(p, end, ',', &uid[n])) return -1;
    if (!parse_i32(p, end, ',', &pid[n])) return -1;
    if (!parse_i32(p, end, ',', &domain[n])) return -1;
    if (!parse_f32_to_eol(p, end, &label[n])) return -1;
    ++n;
  }
  return n;
}

}  // extern "C"
