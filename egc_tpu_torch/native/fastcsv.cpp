// Fast numeric-CSV parser for the on-disk dataset readers (the port's copy
// of egc_tpu/native/fastcsv.cpp; egc_tpu_torch/native/__init__.py builds
// it with g++ and binds it over ctypes). Input is decompressed CSV text
// (gzip handled by Python's zlib); this file turns text into typed arrays
// at memory bandwidth using all cores.
//
// Exported ABI (all little-endian, caller-allocated output):
//   fastcsv_count(data, len)            -> number of numeric fields
//   fastcsv_check_rows(data, len, cols) -> rows, or -1 on a ragged row
//   fastcsv_parse_f32(data, len, out, cap) -> fields parsed, -1 if they
//       exceed cap, -2 if a field is not a whole number of the type
//   fastcsv_parse_f64(...), fastcsv_parse_i64(...)
//
// A "field" is any maximal run of non-separator bytes; separators are
// ',', '\n', '\r', ' ', '\t'. Every value is the one egc_tpu's parser
// gives (std::from_chars, locale-independent, correctly rounded straight
// to the output type: a float32 is rounded once). Where egc_tpu's parser
// stores 0 for a malformed field, this one reports it (-2), so the
// reader raises instead of reading a wrong value.

#include <charconv>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline bool is_sep(char c) {
    return c == ',' || c == '\n' || c == '\r' || c == ' ' || c == '\t';
}

// Split [0, len) into per-thread ranges aligned to separator boundaries so
// no field straddles two threads.
std::vector<std::pair<int64_t, int64_t>> ranges(const char* data, int64_t len,
                                                int nthreads) {
    std::vector<std::pair<int64_t, int64_t>> out;
    int64_t start = 0;
    for (int t = 0; t < nthreads; ++t) {
        int64_t end = (t == nthreads - 1) ? len : len * (t + 1) / nthreads;
        if (end < len) {
            while (end > start && !is_sep(data[end - 1])) --end;
            if (end == start) end = (t == nthreads - 1) ? len : end;
        }
        out.emplace_back(start, end);
        start = end;
    }
    out.back().second = len;
    return out;
}

int64_t count_range(const char* data, int64_t lo, int64_t hi) {
    int64_t n = 0;
    bool in_field = false;
    for (int64_t i = lo; i < hi; ++i) {
        bool sep = is_sep(data[i]);
        if (!sep && !in_field) ++n;
        in_field = !sep;
    }
    return n;
}

// Split [0, len) into per-thread ranges aligned to LINE boundaries so each
// thread sees whole rows (check_rows needs per-row field counts).
std::vector<std::pair<int64_t, int64_t>> line_ranges(const char* data,
                                                     int64_t len,
                                                     int nthreads) {
    std::vector<std::pair<int64_t, int64_t>> out;
    int64_t start = 0;
    for (int t = 0; t < nthreads; ++t) {
        int64_t end = (t == nthreads - 1) ? len : len * (t + 1) / nthreads;
        if (end < len) {
            while (end > start && data[end - 1] != '\n') --end;
            if (end == start) end = (t == nthreads - 1) ? len : end;
        }
        out.emplace_back(start, end);
        start = end;
    }
    out.back().second = len;
    return out;
}

// Count non-empty rows in [lo, hi); set *ok=false if any non-empty row has
// a field count != cols. Fields within a row also split on ' '/'\t' (same
// separator set as the parser), so an embedded space in a field shows up
// as an extra field here and fails the check instead of silently
// misaligning the flat reshape.
int64_t check_rows_range(const char* data, int64_t lo, int64_t hi,
                         int64_t cols, bool* ok) {
    int64_t rows = 0, fields = 0;
    bool in_field = false;
    for (int64_t i = lo; i < hi; ++i) {
        char c = data[i];
        if (c == '\n' || c == '\r') {
            if (fields > 0) {
                if (fields != cols) { *ok = false; return rows; }
                ++rows;
            }
            fields = 0;
            in_field = false;
            continue;
        }
        bool sep = is_sep(c);
        if (!sep && !in_field) ++fields;
        in_field = !sep;
    }
    if (fields > 0) {  // final unterminated line
        if (fields != cols) { *ok = false; return rows; }
        ++rows;
    }
    return rows;
}

int nthreads_for(int64_t len) {
    unsigned hw = std::thread::hardware_concurrency();
    if (hw == 0) hw = 1;
    // below ~4 MB the spawn overhead dominates
    int64_t want = len / (4 << 20) + 1;
    return static_cast<int>(want < static_cast<int64_t>(hw) ? want : hw);
}

// parse_one(p, end, out) stores the field's value and returns the end of
// what it parsed, or nullptr when the field does not start with a value
// of the type; a field is malformed unless the value spans all of it.
template <typename T, typename Parse>
int64_t parse_all(const char* data, int64_t len, T* out, int64_t cap,
                  Parse parse_one) {
    int nt = nthreads_for(len);
    auto rs = ranges(data, len, nt);
    std::vector<int64_t> counts(nt);
    {
        std::vector<std::thread> th;
        for (int t = 0; t < nt; ++t)
            th.emplace_back([&, t] {
                counts[t] = count_range(data, rs[t].first, rs[t].second);
            });
        for (auto& x : th) x.join();
    }
    std::vector<int64_t> offset(nt + 1, 0);
    for (int t = 0; t < nt; ++t) offset[t + 1] = offset[t] + counts[t];
    if (offset[nt] > cap) return -1;
    std::vector<uint8_t> bad(nt, 0);
    {
        std::vector<std::thread> th;
        for (int t = 0; t < nt; ++t)
            th.emplace_back([&, t] {
                const char* p = data + rs[t].first;
                const char* end = data + rs[t].second;
                T* o = out + offset[t];
                while (p < end) {
                    while (p < end && is_sep(*p)) ++p;
                    if (p >= end) break;
                    const char* q = parse_one(p, end, o);
                    ++o;
                    // always advance past the field
                    const char* f = p + 1;
                    while (f < end && !is_sep(*f)) ++f;
                    if (q != f) bad[t] = 1;
                    p = f;
                }
            });
        for (auto& x : th) x.join();
    }
    for (int t = 0; t < nt; ++t)
        if (bad[t]) return -2;
    return offset[nt];
}

}  // namespace

extern "C" {

// Per-row structure check: returns the number of non-empty rows when every
// non-empty row has exactly `cols` fields, else -1. Total field count alone
// (rows*cols) lets offsetting malformed rows (cols+1 here, cols-1 there)
// silently misalign the reshape — this closes that hole.
int64_t fastcsv_check_rows(const char* data, int64_t len, int64_t cols) {
    int nt = nthreads_for(len);
    auto rs = line_ranges(data, len, nt);
    std::vector<int64_t> counts(nt);
    std::vector<uint8_t> oks(nt, 1);
    std::vector<std::thread> th;
    for (int t = 0; t < nt; ++t)
        th.emplace_back([&, t] {
            bool ok = true;
            counts[t] = check_rows_range(data, rs[t].first, rs[t].second,
                                         cols, &ok);
            oks[t] = ok ? 1 : 0;
        });
    for (auto& x : th) x.join();
    int64_t rows = 0;
    for (int t = 0; t < nt; ++t) {
        if (!oks[t]) return -1;
        rows += counts[t];
    }
    return rows;
}

int64_t fastcsv_count(const char* data, int64_t len) {
    int nt = nthreads_for(len);
    auto rs = ranges(data, len, nt);
    std::vector<int64_t> counts(nt);
    std::vector<std::thread> th;
    for (int t = 0; t < nt; ++t)
        th.emplace_back([&, t, rs] {
            counts[t] = count_range(data, rs[t].first, rs[t].second);
        });
    for (auto& x : th) x.join();
    int64_t n = 0;
    for (auto c : counts) n += c;
    return n;
}

// std::from_chars: locale-INDEPENDENT (strtof/strtod honor LC_NUMERIC —
// a comma-decimal locale silently truncates floats at the '.') and
// bounds-checked against the buffer end. A malformed field stores 0, as
// in egc_tpu's parser, and makes the parse return -2.

int64_t fastcsv_parse_f32(const char* data, int64_t len, float* out,
                          int64_t cap) {
    return parse_all<float>(
        data, len, out, cap,
        [](const char* p, const char* end, float* v) {
            auto r = std::from_chars(p, end, *v,
                                     std::chars_format::general);
            if (r.ec != std::errc()) {
                *v = 0.0f;
                return static_cast<const char*>(nullptr);
            }
            return r.ptr;
        });
}

int64_t fastcsv_parse_f64(const char* data, int64_t len, double* out,
                          int64_t cap) {
    return parse_all<double>(
        data, len, out, cap,
        [](const char* p, const char* end, double* v) {
            auto r = std::from_chars(p, end, *v,
                                     std::chars_format::general);
            if (r.ec != std::errc()) {
                *v = 0.0;
                return static_cast<const char*>(nullptr);
            }
            return r.ptr;
        });
}

int64_t fastcsv_parse_i64(const char* data, int64_t len, int64_t* out,
                          int64_t cap) {
    return parse_all<int64_t>(
        data, len, out, cap,
        [](const char* p, const char* end, int64_t* v) {
            auto r = std::from_chars(p, end, *v);
            if (r.ec != std::errc()) {
                *v = 0;
                return static_cast<const char*>(nullptr);
            }
            return r.ptr;
        });
}

}  // extern "C"
