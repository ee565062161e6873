// Streaming FASTA/FASTQ record reader + LUT encoder (header-only core).
//
// Shared by fastx_reader.cpp (the ctypes-facing record iterator) and
// oph_sketch.cpp's file-driver engine (read + encode + sketch in one
// native pass, no per-record Python). From-scratch parser playing the
// role of the reference's kseq + feeder ingest
// (upstream Dashing2's src/fqfeeder.cpp, d2.h:273-305).

#ifndef DASHING2_TPU_FASTX_READER_H
#define DASHING2_TPU_FASTX_READER_H

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <zlib.h>

namespace d2fastx {

constexpr size_t kChunk = 1 << 20;

struct Reader {
    gzFile fp = nullptr;
    // input buffer
    unsigned char *buf = nullptr;
    size_t buf_len = 0, buf_pos = 0;
    bool eof = false;
    // record storage (reused across next() calls)
    char *name = nullptr;
    size_t name_cap = 0;
    unsigned char *seq = nullptr;
    size_t seq_cap = 0, seq_len = 0;
    int fastq = -1;  // -1 unknown, 0 fasta, 1 fastq
    unsigned char lut[256];

    bool open(const char *path, const unsigned char *lut256) {
        fp = gzopen(path, "rb");
        if (!fp) return false;
        gzbuffer(fp, 1 << 20);
        buf = (unsigned char *)malloc(kChunk);
        buf_len = buf_pos = 0;
        eof = false;
        fastq = -1;
        memcpy(lut, lut256, 256);
        return true;
    }
    void close() {
        if (fp) { gzclose(fp); fp = nullptr; }
        free(buf); buf = nullptr;
        free(name); name = nullptr; name_cap = 0;
        free(seq); seq = nullptr; seq_cap = seq_len = 0;
    }

    bool fill() {
        if (eof) return buf_pos < buf_len;
        if (buf_pos < buf_len) return true;
        int n = gzread(fp, buf, kChunk);
        if (n <= 0) { eof = true; return false; }
        buf_len = size_t(n);
        buf_pos = 0;
        return true;
    }
    int peek() {
        if (!fill()) return -1;
        return buf[buf_pos];
    }
    int getc_() {
        if (!fill()) return -1;
        return buf[buf_pos++];
    }
    // append line (up to '\n', not included) through lut into seq
    bool read_seq_line() {
        for (;;) {
            if (!fill()) return false;
            unsigned char *nl = (unsigned char *)memchr(
                buf + buf_pos, '\n', buf_len - buf_pos);
            size_t end = nl ? size_t(nl - buf) : buf_len;
            size_t n = end - buf_pos;
            if (seq_len + n + 1 > seq_cap) {
                seq_cap = (seq_len + n + 1) * 2;
                seq = (unsigned char *)realloc(seq, seq_cap);
            }
            for (size_t i = 0; i < n; ++i)
                seq[seq_len + i] = lut[buf[buf_pos + i]];
            seq_len += n;
            buf_pos = end;
            if (nl) { ++buf_pos; return true; }
            if (eof) return true;
        }
    }
    bool skip_line() {
        for (;;) {
            if (!fill()) return false;
            unsigned char *nl = (unsigned char *)memchr(
                buf + buf_pos, '\n', buf_len - buf_pos);
            if (nl) { buf_pos = size_t(nl - buf) + 1; return true; }
            buf_pos = buf_len;
            if (eof) return false;
        }
    }
    bool read_name_line() {
        size_t len = 0;
        for (;;) {
            if (!fill()) { if (len) break; return false; }
            unsigned char *nl = (unsigned char *)memchr(
                buf + buf_pos, '\n', buf_len - buf_pos);
            size_t end = nl ? size_t(nl - buf) : buf_len;
            size_t n = end - buf_pos;
            if (len + n + 1 > name_cap) {
                name_cap = (len + n + 1) * 2;
                name = (char *)realloc(name, name_cap);
            }
            memcpy(name + len, buf + buf_pos, n);
            len += n;
            buf_pos = end;
            if (nl) { ++buf_pos; break; }
            if (eof) break;
        }
        name[len] = 0;
        // trim at first whitespace
        for (size_t i = 0; i < len; ++i) {
            if (name[i] == ' ' || name[i] == '\t' || name[i] == '\r') {
                name[i] = 0;
                break;
            }
        }
        return true;
    }

    // Advance to the next record. Returns the sequence length (>= 0,
    // encoded bytes in `seq`), -1 at end of input, -2 on malformed
    // input.
    long next() {
        int c = getc_();
        while (c == '\n' || c == '\r') c = getc_();
        if (c < 0) return -1;
        if (fastq == -1) fastq = (c == '@');
        if (c != '>' && c != '@') return -2;
        if (!read_name_line()) return -1;
        seq_len = 0;
        if (fastq) {
            if (!read_seq_line()) return -2;
            // '+' line then quality line (same byte length as seq)
            if (peek() == '+') {
                skip_line();
                size_t toskip = seq_len;
                while (toskip) {
                    if (!fill()) break;
                    size_t n = buf_len - buf_pos;
                    if (n > toskip) n = toskip;
                    buf_pos += n;
                    toskip -= n;
                }
                skip_line();
            }
        } else {
            for (;;) {
                int p = peek();
                if (p < 0 || p == '>') break;
                if (!read_seq_line()) break;
            }
        }
        return long(seq_len);
    }
};

}  // namespace d2fastx

#endif  // DASHING2_TPU_FASTX_READER_H
