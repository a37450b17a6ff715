// Native data-plane loader for sparrowrecsys_tpu.
//
// Fills the runtime role the reference delegates to heavyweight engines
// (Spark's JVM CSV reader feeding the feature jobs, the JVM loader behind
// DataManager.loadData): parsing multi-million-row MovieLens ratings and
// `id:f f ...` embedding artifacts at memory bandwidth instead of Python
// loop speed. Exposed as a C ABI consumed via ctypes
// (sparrowrecsys_tpu/native/loader.py); the Python path remains as a
// fallback so the framework runs without a toolchain.
//
// Build: make -C native   (g++ -O3 -shared -fPIC)

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace {

// Fast positive-integer parse; returns -1 on malformed input.
inline int64_t parse_int(const char*& p, const char* end) {
  int64_t v = 0;
  bool any = false;
  while (p < end && *p >= '0' && *p <= '9') {
    v = v * 10 + (*p - '0');
    ++p;
    any = true;
  }
  return any ? v : -1;
}

// Locale-independent float parse ('.' decimal point always; strtod honors
// LC_NUMERIC and silently breaks under e.g. de_DE). Handles
// [+-]digits[.digits][eE[+-]digits] — the full range of repr(float).
inline double parse_float(const char*& p, const char* end) {
  const char* start = p;
  bool neg = false;
  if (p < end && (*p == '+' || *p == '-')) neg = (*p++ == '-');
  double v = 0.0;
  bool any = false;
  while (p < end && *p >= '0' && *p <= '9') {
    v = v * 10.0 + (*p++ - '0');
    any = true;
  }
  if (p < end && *p == '.') {
    ++p;
    double scale = 0.1;
    while (p < end && *p >= '0' && *p <= '9') {
      v += (*p++ - '0') * scale;
      scale *= 0.1;
      any = true;
    }
  }
  if (!any) { p = start; return -1e300; }
  if (p < end && (*p == 'e' || *p == 'E')) {
    const char* epos = p;
    ++p;
    bool eneg = false;
    if (p < end && (*p == '+' || *p == '-')) eneg = (*p++ == '-');
    int ev = 0;
    bool eany = false;
    while (p < end && *p >= '0' && *p <= '9') {
      ev = ev * 10 + (*p++ - '0');
      eany = true;
    }
    if (!eany) {
      p = epos;  // bare 'e' is not an exponent
    } else {
      double mul = 1.0;
      for (int i = 0; i < ev; ++i) mul *= 10.0;
      v = eneg ? v / mul : v * mul;
    }
  }
  return neg ? -v : v;
}

inline void skip_to(const char*& p, const char* end, char c) {
  while (p < end && *p != c) ++p;
  if (p < end) ++p;  // past the delimiter
}

struct Buffer {
  char* data = nullptr;
  size_t size = 0;
};

bool read_file(const char* path, Buffer* buf) {
  FILE* f = fopen(path, "rb");
  if (!f) return false;
  fseek(f, 0, SEEK_END);
  long n = ftell(f);
  if (n < 0) {  // e.g. path is a directory: fall back to the Python parser
    fclose(f);
    return false;
  }
  fseek(f, 0, SEEK_SET);
  buf->data = static_cast<char*>(malloc(n + 1));
  if (!buf->data) {
    fclose(f);
    return false;
  }
  buf->size = fread(buf->data, 1, n, f);
  buf->data[buf->size] = '\0';
  fclose(f);
  return true;
}

}  // namespace

extern "C" {

// Parse a `userId,movieId,rating,timestamp` CSV (header skipped).
// Returns the row count, filling caller-provided arrays sized via
// count_csv_rows(). Malformed rows are skipped (ignore_errors parity
// with make_csv_dataset / the Scala loaders).
int64_t count_csv_rows(const char* path) {
  Buffer buf;
  if (!read_file(path, &buf)) return -1;
  int64_t rows = 0;
  for (size_t i = 0; i < buf.size; ++i)
    if (buf.data[i] == '\n') ++rows;
  if (buf.size > 0 && buf.data[buf.size - 1] != '\n') ++rows;
  free(buf.data);
  return rows > 0 ? rows - 1 : 0;  // minus header
}

int64_t load_ratings_csv(const char* path, int32_t* user_ids,
                         int32_t* movie_ids, float* ratings,
                         int64_t* timestamps, int64_t capacity) {
  Buffer buf;
  if (!read_file(path, &buf)) return -1;
  const char* p = buf.data;
  const char* end = buf.data + buf.size;
  skip_to(p, end, '\n');  // header
  int64_t n = 0;
  while (p < end && n < capacity) {
    const char* line_start = p;
    int64_t u = parse_int(p, end);
    if (p >= end || *p != ',') { skip_to(p, end, '\n'); continue; }
    ++p;
    int64_t m = parse_int(p, end);
    if (p >= end || *p != ',') { skip_to(p, end, '\n'); continue; }
    ++p;
    double r = parse_float(p, end);
    if (p >= end || *p != ',') { skip_to(p, end, '\n'); continue; }
    ++p;
    int64_t t = parse_int(p, end);
    skip_to(p, end, '\n');
    if (u < 0 || m < 0 || r == -1e300 || t < 0 || p == line_start) continue;
    user_ids[n] = static_cast<int32_t>(u);
    movie_ids[n] = static_cast<int32_t>(m);
    ratings[n] = static_cast<float>(r);
    timestamps[n] = t;
    ++n;
  }
  free(buf.data);
  return n;
}

// Parse an `id:f f f ...` embedding artifact. Two-pass API:
// probe_embeddings fills *rows/*dim; load_embeddings fills ids + a
// row-major [rows, dim] matrix.
int64_t probe_embeddings(const char* path, int64_t* dim) {
  Buffer buf;
  if (!read_file(path, &buf)) return -1;
  const char* p = buf.data;
  const char* end = buf.data + buf.size;
  // dim from the first line
  const char* q = p;
  skip_to(q, end, ':');
  int64_t d = 0;
  while (q < end && *q != '\n') {
    while (q < end && (*q == ' ' || *q == '\r')) ++q;
    if (q >= end || *q == '\n') break;
    ++d;
    while (q < end && *q != ' ' && *q != '\n' && *q != '\r') ++q;
  }
  *dim = d;
  int64_t rows = 0;
  for (const char* c = buf.data; c < end; ++c)
    if (*c == '\n') ++rows;
  if (buf.size > 0 && buf.data[buf.size - 1] != '\n') ++rows;
  free(buf.data);
  return rows;
}

int64_t load_embeddings(const char* path, int64_t* ids, float* matrix,
                        int64_t rows, int64_t dim) {
  Buffer buf;
  if (!read_file(path, &buf)) return -1;
  const char* p = buf.data;
  const char* end = buf.data + buf.size;
  int64_t n = 0;
  while (p < end && n < rows) {
    int64_t id = parse_int(p, end);
    if (p >= end || *p != ':') { skip_to(p, end, '\n'); continue; }
    ++p;
    float* row = matrix + n * dim;
    int64_t d = 0;
    bool extra = false;
    while (p < end && *p != '\n') {
      while (p < end && (*p == ' ' || *p == '\r')) ++p;
      if (p >= end || *p == '\n') break;
      if (d >= dim) { extra = true; break; }  // wider row than probed dim
      row[d++] = static_cast<float>(parse_float(p, end));
    }
    skip_to(p, end, '\n');
    // Reject rows whose width disagrees with the probed dim in EITHER
    // direction — a short first line must not silently truncate the file.
    if (id >= 0 && d == dim && !extra) {
      ids[n] = id;
      ++n;
    }
  }
  free(buf.data);
  return n;
}

// Generic typed-column CSV table parser — the native fast path for the
// reference's 27-column sample schema (load_samples_csv,
// sparrowrecsys_tpu/data/dataset.py). The Python wrapper reads the
// header, then passes one `kind` per CSV column:
//   0 = skip, 1 = int32 (parse as float, cast — "1.0" is legal),
//   2 = float32, 3 = genre (index into the '\n'-joined vocab, -1 OOV),
//   4 = int64.
// Outputs are column-major blocks: the j-th column of a given kind
// writes at out[j * capacity + row]. Missing/garbage numerics parse as
// 0 (na_value="0" parity, dataset.py::_parse_float); unknown genre
// strings -> -1.
int64_t load_table_csv(const char* path, const int32_t* kinds,
                       int64_t n_cols, const char* genre_vocab,
                       int32_t* i32_out, float* f32_out, int32_t* gen_out,
                       int64_t* i64_out, int64_t capacity) {
  Buffer buf;
  if (!read_file(path, &buf)) return -1;

  // split vocab on '\n'
  const char* gv[64];
  size_t gvlen[64];
  int n_genres = 0;
  {
    const char* g = genre_vocab;
    while (*g && n_genres < 64) {
      const char* s = g;
      while (*g && *g != '\n') ++g;
      gv[n_genres] = s;
      gvlen[n_genres] = static_cast<size_t>(g - s);
      ++n_genres;
      if (*g == '\n') ++g;
    }
  }

  // Python-fallback parity (`dataset.load_samples_csv`): a row only needs
  // fields up to the LAST sample column (kind != 0); trailing non-sample
  // header columns may be absent from data rows.
  int64_t required = 0;
  for (int64_t c = 0; c < n_cols; ++c)
    if (kinds[c] != 0) required = c + 1;

  const char* p = buf.data;
  const char* end = buf.data + buf.size;
  skip_to(p, end, '\n');  // header (column kinds were derived from it)
  int64_t n = 0;
  while (p < end && n < capacity) {
    // record field start/length for all n_cols fields of this line
    int64_t i32_j = 0, f32_j = 0, gen_j = 0, i64_j = 0;
    bool ok = true;
    for (int64_t c = 0; c < n_cols; ++c) {
      const char* fs = p;
      while (p < end && *p != ',' && *p != '\n' && *p != '\r') ++p;
      size_t flen = static_cast<size_t>(p - fs);
      int32_t kind = kinds[c];
      if (kind == 1 || kind == 2 || kind == 4) {
        const char* q = fs;
        double v = flen ? parse_float(q, fs + flen) : 0.0;
        // na/garbage/trailing junk ('12abc')/overflow-to-inf -> 0,
        // matching the Python fallback's full-string finite float()
        // (_parse_float parity)
        if (v == -1e300 || q != fs + flen || !std::isfinite(v)) v = 0.0;
        if (kind == 1)
          i32_out[i32_j++ * capacity + n] = static_cast<int32_t>(v);
        else if (kind == 2)
          f32_out[f32_j++ * capacity + n] = static_cast<float>(v);
        else
          i64_out[i64_j++ * capacity + n] = static_cast<int64_t>(v);
      } else if (kind == 3) {
        int32_t idx = -1;
        for (int g = 0; g < n_genres; ++g) {
          if (gvlen[g] == flen && memcmp(gv[g], fs, flen) == 0) {
            idx = g;
            break;
          }
        }
        gen_out[gen_j++ * capacity + n] = idx;
      }
      if (p < end && *p == '\r') ++p;
      if (c + 1 < n_cols) {
        if (p < end && *p == ',') {
          ++p;
        } else {
          // Row ended early. Keep it if every sample column was present
          // (only kind-0 trailing columns missing); else skip
          // (ignore_errors parity).
          ok = (c + 1 >= required);
          break;
        }
      }
    }
    skip_to(p, end, '\n');
    if (ok) ++n;
  }
  free(buf.data);
  return n;
}

}  // extern "C"
