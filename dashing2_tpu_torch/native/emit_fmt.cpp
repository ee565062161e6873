// Native float-row formatter for the human-readable emitters.
//
// The reference batches distance-row formatting through fmt's
// memory_buffer ("{}" = shortest round-trip; src/emitrect.cpp:79-106) on
// dedicated threads because text formatting dominates human-readable
// emission. Python-per-value formatting is ~1us/value; this uses C++17
// std::to_chars (shortest round-trip, the same Ryu/Grisu family) at
// ~20ns/value.
//
// fmt_f32_rows(vals, n, sep, out, cap):
//   writes "<sep><v0><sep><v1>..." into out; returns bytes written, or
//   the required capacity if cap was insufficient (call again with a
//   bigger buffer; nothing is written in that case beyond what fit).

#include <charconv>
#include <cstddef>
#include <cstdio>
#include <cstring>

extern "C" size_t fmt_f32_rows(const float* vals, size_t n, char sep,
                               char* out, size_t cap) {
    char* p = out;
    char* end = out + cap;
    for (size_t i = 0; i < n; ++i) {
        if (p + 24 > end) {
            // not enough room: report a safe required size
            return cap + (n - i) * 24 + 24;
        }
        *p++ = sep;
        float v = vals[i];
        if (v != v) {
            std::memcpy(p, "nan", 3); p += 3;
        } else if (v == __builtin_inff()) {
            std::memcpy(p, "inf", 3); p += 3;
        } else if (v == -__builtin_inff()) {
            std::memcpy(p, "-inf", 4); p += 4;
        } else {
            auto res = std::to_chars(p, end, v);
            p = res.ptr;
        }
    }
    return static_cast<size_t>(p - out);
}
