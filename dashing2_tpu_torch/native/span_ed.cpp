// Edit distances over token sequences (the minimizer sequences of
// --seq): the O(nm) unit-cost Levenshtein DP of src/edit-distance.h:12-57
// over u64 tokens, or u128 tokens as (lo, hi) word pairs, for a batch of
// pairs fanned across threads. The same integers as the numpy prefix-min
// form `span_edit_distance` of cmp/editdist.py (tests/test_torch_seq.py).

#include <algorithm>
#include <atomic>
#include <cstdint>
#include <thread>
#include <vector>

namespace {

// Distance of a[0, n) and b[0, m); hi words compared too when given.
int64_t span_ed(const uint64_t* alo, const uint64_t* ahi, int64_t n,
                const uint64_t* blo, const uint64_t* bhi, int64_t m,
                std::vector<int64_t>& row) {
    if (n == 0) return m;
    if (m == 0) return n;
    if (n > m) {                    // the row over the longer sequence
        std::swap(alo, blo);
        std::swap(ahi, bhi);
        std::swap(n, m);
    }
    row.resize(m + 1);
    for (int64_t j = 0; j <= m; ++j) row[j] = j;
    for (int64_t i = 1; i <= n; ++i) {
        const uint64_t x = alo[i - 1];
        const uint64_t xh = ahi ? ahi[i - 1] : 0;
        int64_t diag = row[0];
        row[0] = i;
        for (int64_t j = 1; j <= m; ++j) {
            const int64_t up = row[j];
            const int64_t ne = (blo[j - 1] != x)
                | (bhi != nullptr && bhi[j - 1] != xh);
            row[j] = std::min(std::min(up, row[j - 1]) + 1, diag + ne);
            diag = up;
        }
    }
    return row[m];
}

}  // namespace

extern "C" {

// out[p] = the distance of sequences ia[p] and ib[p]; sequence s holds
// tokens [offs[s], offs[s + 1]) of lo (and of hi, which may be null for
// u64 tokens).
void span_ed_batch(const uint64_t* lo, const uint64_t* hi,
                   const int64_t* offs, const int64_t* ia,
                   const int64_t* ib, int64_t npairs, int nthreads,
                   int64_t* out) {
    std::atomic<int64_t> next{0};
    auto work = [&]() {
        std::vector<int64_t> row;
        for (;;) {
            const int64_t p0 = next.fetch_add(16);
            if (p0 >= npairs) return;
            const int64_t p1 = std::min(p0 + 16, npairs);
            for (int64_t p = p0; p < p1; ++p) {
                const int64_t a = ia[p], b = ib[p];
                out[p] = span_ed(lo + offs[a], hi ? hi + offs[a] : nullptr,
                                 offs[a + 1] - offs[a], lo + offs[b],
                                 hi ? hi + offs[b] : nullptr,
                                 offs[b + 1] - offs[b], row);
            }
        }
    };
    nthreads = std::max(1, nthreads);
    std::vector<std::thread> pool;
    for (int t = 1; t < nthreads; ++t) pool.emplace_back(work);
    work();
    for (auto& t : pool) t.join();
}

}  // extern "C"
