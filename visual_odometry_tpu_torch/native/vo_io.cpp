// Fast dataset parser for the reference on-disk format.
//
// A copy of the JAX package's parser (visual_odometry_tpu/native/vo_io.cpp),
// kept in the PyTorch port so that the port imports nothing of that package.
// The reference's parsers are C++ iostream loops (files_utils.cpp:19-93);
// this one mmaps the file and scans it with strtod directly, no stream
// machinery, no per-line string allocation. Exposed through a minimal C ABI
// consumed via ctypes (visual_odometry_tpu_torch/native/dataloader.py).
//
// Grammar: whitespace-separated token table. The first `skiprows` lines are
// skipped; on each remaining non-empty line, `first_col` leading tokens are
// discarded (e.g. the literal "point" keyword) and the next `n_cols` tokens
// are parsed as doubles. Lines with fewer than first_col + n_cols tokens
// are ignored (matches the loadtxt/getline tolerance for blank tails).

#include <algorithm>
#include <atomic>
#include <cctype>
#include <cstdlib>
#include <cstring>
#include <string>
#include <thread>
#include <vector>

#include <dirent.h>
#include <fcntl.h>
#include <sys/mman.h>
#include <sys/stat.h>
#include <unistd.h>

namespace {

inline const char* skip_ws(const char* p, const char* end) {
  while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
  return p;
}

inline const char* skip_token(const char* p, const char* end) {
  while (p < end && *p != ' ' && *p != '\t' && *p != '\r' && *p != '\n') ++p;
  return p;
}

// Shared parse core of vo_parse_table (mmap + strtod token scan).
// Appends row-major values to ``values``; returns rows or -1.
long parse_table_into(const char* path, int skiprows, int first_col,
                      int n_cols, std::vector<double>& values) {
  int fd = open(path, O_RDONLY);
  if (fd < 0) return -1;
  struct stat st;
  if (fstat(fd, &st) != 0 || st.st_size == 0) {
    close(fd);
    return st.st_size == 0 ? 0 : -1;
  }
  const size_t size = static_cast<size_t>(st.st_size);
  void* mapped = mmap(nullptr, size, PROT_READ, MAP_PRIVATE, fd, 0);
  close(fd);
  if (mapped == MAP_FAILED) return -1;
  const char* p = static_cast<const char*>(mapped);
  const char* end = p + size;

  for (int i = 0; i < skiprows && p < end; ++i) {
    while (p < end && *p != '\n') ++p;
    if (p < end) ++p;
  }

  long rows = 0;
  while (p < end) {
    p = skip_ws(p, end);
    if (p >= end) break;
    if (*p == '\n') {  // empty line
      ++p;
      continue;
    }
    const char* line_end = p;
    while (line_end < end && *line_end != '\n') ++line_end;

    const char* q = p;
    bool ok = true;
    for (int c = 0; c < first_col; ++c) {
      q = skip_ws(q, line_end);
      const char* t = skip_token(q, line_end);
      if (t == q) {
        ok = false;
        break;
      }
      q = t;
    }
    size_t row_start = values.size();
    if (ok) {
      for (int c = 0; c < n_cols; ++c) {
        q = skip_ws(q, line_end);
        char* next = nullptr;
        double v = strtod(q, &next);
        if (next == q || next > line_end) {
          ok = false;
          break;
        }
        values.push_back(v);
        q = next;
      }
    }
    if (ok) {
      ++rows;
    } else {
      values.resize(row_start);  // drop partial row (short/blank line)
    }
    p = (line_end < end) ? line_end + 1 : end;
  }
  munmap(mapped, size);
  return rows;
}

// ^meas-\d.*\.dat$  (vo_complete.cpp:80 / utils/io.py MEAS_PATTERN).
bool is_meas_name(const char* name) {
  const size_t len = std::strlen(name);
  if (len < 10) return false;  // "meas-D.dat"
  if (std::strncmp(name, "meas-", 5) != 0) return false;
  if (!std::isdigit(static_cast<unsigned char>(name[5]))) return false;
  return std::strcmp(name + len - 4, ".dat") == 0;
}

}  // namespace

extern "C" {

// Returns the number of parsed rows (>= 0) and stores a malloc'd row-major
// [rows x n_cols] double array in *out_data (caller frees via vo_free), or
// returns -1 on I/O failure / parse error.
long vo_parse_table(const char* path, int skiprows, int first_col, int n_cols,
                    double** out_data) {
  *out_data = nullptr;
  std::vector<double> values;
  values.reserve(1024);
  long rows = parse_table_into(path, skiprows, first_col, n_cols, values);
  if (rows < 0) return -1;
  double* out = static_cast<double*>(malloc(values.size() * sizeof(double)));
  if (!out && !values.empty()) return -1;
  std::memcpy(out, values.data(), values.size() * sizeof(double));
  *out_data = out;
  return rows;
}

void vo_free(double* p) { free(p); }

// Threaded whole-sequence loader: parse every ^meas-\d.*\.dat$ under
// ``dir`` (sorted by name => frame order, files_utils.cpp:3-18) into the
// framework's PADDED static-shape arrays (utils/io.pad_frames contract):
//   points (F, S, 2) f32; apps (F, S, 10) f32 (pad = pad_appearance);
//   ids (F, S) i32 (pad = -1); mask (F, S) u8; counts (F,) i32.
// Files are parsed by a pool of worker threads (the Python loop's per-file
// round trips are the serving ingest bottleneck: one sequence loads in
// ~25 ms serial vs ~1-2 ms of device tracking time). ``n_slots_in`` <= 0
// auto-sizes to the max frame count rounded up to a multiple of 128.
// Returns F, or -1 on I/O failure or a frame exceeding n_slots. All five
// output buffers are malloc'd; free each with vo_free_buf.
long vo_load_sequence(const char* dir, int n_slots_in, float pad_appearance,
                      float** out_points, float** out_apps, int** out_ids,
                      unsigned char** out_mask, int** out_counts,
                      int* n_slots_out) {
  *out_points = nullptr;
  *out_apps = nullptr;
  *out_ids = nullptr;
  *out_mask = nullptr;
  *out_counts = nullptr;

  std::vector<std::string> names;
  {
    DIR* d = opendir(dir);
    if (!d) return -1;
    while (dirent* e = readdir(d)) {
      if (is_meas_name(e->d_name)) names.emplace_back(e->d_name);
    }
    closedir(d);
  }
  std::sort(names.begin(), names.end());
  const long f = static_cast<long>(names.size());
  if (f == 0) return -1;

  // Parse all files in parallel; each frame's 14-column token table
  // (point_idx, id, col, row, 10 appearance) exactly as vo_parse_table
  // with skiprows=3, first_col=1.
  std::vector<std::vector<double>> tables(f);
  std::vector<long> rows(f, -1);
  const unsigned n_threads =
      std::max(1u, std::min<unsigned>(std::thread::hardware_concurrency(),
                                      static_cast<unsigned>(f)));
  std::atomic<long> next(0);
  std::string base(dir);
  if (!base.empty() && base.back() != '/') base += '/';
  auto worker = [&]() {
    for (long i = next.fetch_add(1); i < f; i = next.fetch_add(1)) {
      std::string path = base + names[i];
      rows[i] = parse_table_into(path.c_str(), 3, 1, 14, tables[i]);
    }
  };
  std::vector<std::thread> pool;
  for (unsigned t = 1; t < n_threads; ++t) pool.emplace_back(worker);
  worker();
  for (auto& t : pool) t.join();

  long max_n = 0;
  for (long i = 0; i < f; ++i) {
    if (rows[i] < 0) return -1;
    max_n = std::max(max_n, rows[i]);
  }
  long s = n_slots_in > 0 ? n_slots_in : ((max_n + 127) / 128) * 128;
  if (s == 0) s = 128;
  if (max_n > s) return -1;

  auto* points = static_cast<float*>(calloc(f * s * 2, sizeof(float)));
  auto* apps = static_cast<float*>(malloc(f * s * 10 * sizeof(float)));
  auto* ids = static_cast<int*>(malloc(f * s * sizeof(int)));
  auto* mask = static_cast<unsigned char*>(calloc(f * s, 1));
  auto* counts = static_cast<int*>(malloc(f * sizeof(int)));
  if (!points || !apps || !ids || !mask || !counts) {
    free(points); free(apps); free(ids); free(mask); free(counts);
    return -1;
  }
  for (long i = 0; i < f * s * 10; ++i) apps[i] = pad_appearance;
  for (long i = 0; i < f * s; ++i) ids[i] = -1;

  for (long i = 0; i < f; ++i) {
    counts[i] = static_cast<int>(rows[i]);
    const double* t = tables[i].data();
    for (long r = 0; r < rows[i]; ++r) {
      const double* row = t + r * 14;  // [point_idx, id, col, row, app x10]
      points[(i * s + r) * 2 + 0] = static_cast<float>(row[2]);
      points[(i * s + r) * 2 + 1] = static_cast<float>(row[3]);
      ids[i * s + r] = static_cast<int>(row[1]);
      for (int c = 0; c < 10; ++c)
        apps[(i * s + r) * 10 + c] = static_cast<float>(row[4 + c]);
      mask[i * s + r] = 1;
    }
  }
  *out_points = points;
  *out_apps = apps;
  *out_ids = ids;
  *out_mask = mask;
  *out_counts = counts;
  *n_slots_out = static_cast<int>(s);
  return f;
}

void vo_free_buf(void* p) { free(p); }

}  // extern "C"
