// Native FASTA/FASTQ reader + alphabet encoder for host ingest.
//
// Role: the reference keeps sequence parsing native (kseq + a salmon-derived
// multithreaded feeder, upstream Dashing2's src/fqfeeder.cpp, d2.h:273-305)
// because host ingest must outpace the device. This is a from-scratch
// streaming parser with the same job: read records from (possibly
// gzip-compressed) FASTA/FASTQ and hand back alphabet-encoded byte arrays
// ready for device packing. Exposed through a C ABI consumed via ctypes
// (no pybind11 in this environment). The parser core lives in
// fastx_reader.h, shared with oph_sketch.cpp's file-driver engine.
//
// Build: g++ -O3 -march=native -shared -fPIC fastx_reader.cpp -o libfastx.so -lz

#include "fastx_reader.h"

extern "C" {

void *fxr_open(const char *path, const unsigned char *lut256) {
    d2fastx::Reader *r = new d2fastx::Reader();
    if (!r->open(path, lut256)) {
        delete r;
        return nullptr;
    }
    return r;
}

// Returns sequence length (>= 0) and sets *name/*seq (valid until next
// call), or -1 at end of input / -2 on malformed input.
long fxr_next(void *h, const char **name_out,
              const unsigned char **seq_out) {
    d2fastx::Reader *r = (d2fastx::Reader *)h;
    long n = r->next();
    if (n < 0) return n;
    *name_out = r->name;
    *seq_out = r->seq;
    return n;
}

void fxr_close(void *h) {
    d2fastx::Reader *r = (d2fastx::Reader *)h;
    r->close();
    delete r;
}

}  // extern "C"
