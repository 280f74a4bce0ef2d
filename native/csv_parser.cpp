// Fast CSV float parser for the tutorial data loader.
//
// Native counterpart of the reference's load() (tutorial/tutorial.go:234-272):
// rows of comma-separated floats, all columns but the last are input
// coordinates.  The Python fallback in gogp/tutorial/io.py is
// line/split/float() — fine for the 20-44 point tutorial sets, but the
// large-N path (BASELINE 16k+ rows) deserves a single-pass scanner.
//
// C ABI (ctypes, no pybind11 in this image):
//   parse_csv(text, text_len, out, max_vals, n_cols) -> n_values or -1
// The caller provides `out` sized at least text_len/2 + 8 doubles (a comma
// or newline follows every value, so values <= text_len/2 + 1).  *n_cols
// receives the first row's column count; rows with a different count make
// the call fail with -1 (the reference errors on ragged rows too).

#include <charconv>
#include <cstdlib>
#include <cstring>

extern "C" {

long parse_csv(const char* text, long text_len, double* out, long max_vals,
               long* n_cols) {
    long n_values = 0;
    long cols_first = -1;
    long cols_cur = 0;
    bool row_has_data = false;
    const char* p = text;
    const char* end = text + text_len;

    while (p < end) {
        // skip horizontal whitespace
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
        if (p < end && *p == '\n') {
            if (row_has_data) {
                if (cols_first < 0) cols_first = cols_cur;
                else if (cols_cur != cols_first) return -1;
            }
            cols_cur = 0;
            row_has_data = false;
            ++p;
            continue;
        }
        if (p >= end) break;
        // std::from_chars: locale-free, ~5x strtod.  It rejects a leading
        // '+', which the reference's strconv.ParseFloat accepts — skip it.
        const char* q = p;
        if (q < end && *q == '+') ++q;
        double v = 0.0;
        auto res = std::from_chars(q, end, v);
        if (res.ec != std::errc() || res.ptr == q) return -1;  // not a number
        const char* next = res.ptr;
        if (n_values >= max_vals) return -1;
        out[n_values++] = v;
        ++cols_cur;
        row_has_data = true;
        p = next;
        while (p < end && (*p == ' ' || *p == '\t' || *p == '\r')) ++p;
        if (p < end && *p == ',') ++p;
    }
    if (row_has_data) {
        if (cols_first < 0) cols_first = cols_cur;
        else if (cols_cur != cols_first) return -1;
    }
    *n_cols = cols_first < 0 ? 0 : cols_first;
    return n_values;
}

}  // extern "C"
