// Blocked Myers bit-parallel Levenshtein distance, batch API.
//
// Independent implementation of the standard published recurrences
// (Myers, JACM 1999; Hyyrö 2003 block formulation) for DISTANCE-ONLY
// global (NW) alignment — the configuration the reference uses through
// its vendored edlib (EDLIB_TASK_DISTANCE at
// upstream dashing2 src/cmp_core.cpp:331-347). Unlike the Python big-int
// form in cmp/editdist.py this runs one pair in O(ceil(m/64) * n) word
// ops and fans a pair batch across std::threads (ctypes releases the
// GIL for the duration of the call).

#include <cstdint>
#include <cstring>
#include <algorithm>
#include <thread>
#include <vector>

namespace {

constexpr uint64_t kTop = 1ULL << 63;

// One text character against one 64-cell block; returns horizontal
// delta out (+1/0/-1) given delta in.
static inline int advance_block(uint64_t eq, uint64_t &pv, uint64_t &mv,
                                int hin) {
  uint64_t xv = eq | mv;
  if (hin < 0) eq |= 1ULL;
  uint64_t xh = (((eq & pv) + pv) ^ pv) | eq;
  uint64_t ph = mv | ~(xh | pv);
  uint64_t mh = pv & xh;
  int hout = 0;
  if (ph & kTop) hout = 1;
  else if (mh & kTop) hout = -1;
  ph = (ph << 1) | (hin > 0 ? 1ULL : 0ULL);
  mh = (mh << 1) | (hin < 0 ? 1ULL : 0ULL);
  pv = mh | ~(xv | ph);
  mv = ph & xv;
  return hout;
}

static int64_t myers_distance(const uint8_t *a, int64_t m, const uint8_t *b,
                              int64_t n, std::vector<uint64_t> &peq) {
  if (m == 0) return n;
  if (n == 0) return m;
  if (m > n) { std::swap(a, b); std::swap(m, n); }
  const int64_t W = (m + 63) / 64;
  peq.assign(256 * W, 0);
  for (int64_t i = 0; i < m; ++i)
    peq[a[i] * W + (i >> 6)] |= 1ULL << (i & 63);
  // last block is padded: pad cells must never go below their column
  // minimum — set their Eq to 0 (default) and start Pv all-ones so the
  // padded rows strictly increase; the score is read at bit (m-1).
  std::vector<uint64_t> pv(W, ~0ULL), mv(W, 0);
  const int last = static_cast<int>(W - 1);
  const uint64_t score_bit = 1ULL << ((m - 1) & 63);
  int64_t score = m;
  for (int64_t j = 0; j < n; ++j) {
    const uint64_t *eqr = &peq[b[j] * W];
    int carry = 1;  // text row: first column boundary increases by 1
    for (int blk = 0; blk <= last; ++blk) {
      // track the score at the pattern's last cell, not the block top
      if (blk == last) {
        uint64_t eq = eqr[blk];
        uint64_t p = pv[blk], mvb = mv[blk];
        uint64_t xv = eq | mvb;
        if (carry < 0) eq |= 1ULL;
        uint64_t xh = (((eq & p) + p) ^ p) | eq;
        uint64_t ph = mvb | ~(xh | p);
        uint64_t mh = p & xh;
        if (ph & score_bit) ++score;
        else if (mh & score_bit) --score;
        ph = (ph << 1) | (carry > 0 ? 1ULL : 0ULL);
        mh = (mh << 1) | (carry < 0 ? 1ULL : 0ULL);
        pv[blk] = mh | ~(xv | ph);
        mv[blk] = ph & xv;
      } else {
        carry = advance_block(eqr[blk], pv[blk], mv[blk], carry);
      }
    }
  }
  return score;
}

// Banded variant with score threshold k (Ukkonen band over the block
// rows). Cells outside the band cannot lie on a <=k path (path cost
// through (i,j) is at least |i-j| + |(m-i)-(n-j)|), so blocks entering
// the band are initialized with the all-+1 overestimate and the first
// processed block takes hin=0 — both safe for threshold semantics:
// a returned score <= k is exact, otherwise the caller doubles k.
static int64_t myers_banded_k(const uint8_t *a, int64_t m, const uint8_t *b,
                              int64_t n, int64_t k,
                              std::vector<uint64_t> &peq,
                              std::vector<uint64_t> &pv,
                              std::vector<uint64_t> &mv,
                              std::vector<int64_t> &bscore) {
  // caller guarantees m <= n and k >= n - m
  const int64_t W = (m + 63) / 64;
  peq.assign(256 * W, 0);
  for (int64_t i = 0; i < m; ++i)
    peq[a[i] * W + (i >> 6)] |= 1ULL << (i & 63);
  pv.assign(W, ~0ULL);
  mv.assign(W, 0);
  // bscore[blk] = value at the block's bit-63 row (exact rows for
  // blk < W-1); the LAST block's tracked cell is the true pattern end
  // at bit (m-1), held in lscore.
  bscore.assign(W, 0);
  for (int64_t blk = 0; blk < W; ++blk)
    bscore[blk] = (blk + 1) * 64;
  const uint64_t score_bit = 1ULL << ((m - 1) & 63);
  int64_t lscore = m;
  const int64_t slack = (k - (n - m)) / 2;
  const int64_t lo_d = -(n - m) - slack;  // i - j >= lo_d
  const int64_t hi_d = slack;             // i - j <= hi_d
  int64_t first = 0, last = std::min<int64_t>(W - 1, hi_d >= 0
                                              ? hi_d / 64 : 0);
  for (int64_t j = 0; j < n; ++j) {
    const int64_t c = j + 1;  // column index after consuming b[j]
    int64_t row_lo = c + lo_d, row_hi = c + hi_d;
    int64_t nfirst = std::max<int64_t>(first, row_lo > 0 ? (row_lo - 1) / 64
                                                         : 0);
    int64_t nlast = std::min<int64_t>(W - 1, row_hi > 0 ? (row_hi - 1) / 64
                                                        : 0);
    if (nlast < nfirst) return k + 1;  // band left the matrix: no <=k path
    // blocks newly entering at the bottom: all-+1 overestimate seeded
    // from the block above (safe: out-of-band cells cannot carry a
    // <=k path, so overestimates never corrupt a reported score <= k)
    for (int64_t blk = last + 1; blk <= nlast; ++blk) {
      pv[blk] = ~0ULL;
      mv[blk] = 0;
      bscore[blk] = bscore[blk - 1] + 64;
      if (blk == W - 1)
        lscore = bscore[blk - 1] + (m - (W - 1) * 64);
    }
    first = nfirst;
    last = nlast;
    const uint64_t *eqr = &peq[b[j] * W];
    int carry = (first == 0) ? 1 : 0;
    for (int64_t blk = first; blk <= last; ++blk) {
      if (blk == W - 1) {
        // track the true pattern-end cell at bit (m-1)
        uint64_t eq = eqr[blk];
        uint64_t p = pv[blk], mvb = mv[blk];
        uint64_t xv = eq | mvb;
        if (carry < 0) eq |= 1ULL;
        uint64_t xh = (((eq & p) + p) ^ p) | eq;
        uint64_t ph = mvb | ~(xh | p);
        uint64_t mh = p & xh;
        if (ph & score_bit) ++lscore;
        else if (mh & score_bit) --lscore;
        ph = (ph << 1) | (carry > 0 ? 1ULL : 0ULL);
        mh = (mh << 1) | (carry < 0 ? 1ULL : 0ULL);
        pv[blk] = mh | ~(xv | ph);
        mv[blk] = ph & xv;
      } else {
        int out = advance_block(eqr[blk], pv[blk], mv[blk], carry);
        bscore[blk] += out;
        carry = out;
      }
    }
  }
  if (last != W - 1) return k + 1;
  return lscore;
}

static int64_t myers_auto(const uint8_t *a, int64_t m, const uint8_t *b,
                          int64_t n, std::vector<uint64_t> &peq,
                          std::vector<uint64_t> &pv,
                          std::vector<uint64_t> &mv,
                          std::vector<int64_t> &bscore) {
  if (m == 0) return n;
  if (n == 0) return m;
  if (m > n) { std::swap(a, b); std::swap(m, n); }
  if (m <= 128)  // band bookkeeping not worth it
    return myers_distance(a, m, b, n, peq);
  int64_t k = std::max<int64_t>(n - m, 1) + 63;
  while (k < m + n) {
    int64_t d = myers_banded_k(a, m, b, n, k, peq, pv, mv, bscore);
    if (d <= k) return d;
    k *= 2;
  }
  return myers_distance(a, m, b, n, peq);
}

}  // namespace

extern "C" {

// seqs: concatenated byte sequences; offsets: (nseqs+1) int64 prefix.
// For each pair p: out[p] = levenshtein(seq[ia[p]], seq[ib[p]]).
void myers_batch(const uint8_t *seqs, const int64_t *offsets,
                 const int64_t *ia, const int64_t *ib, int64_t npairs,
                 int nthreads, int64_t *out) {
  if (nthreads < 1) nthreads = 1;
  nthreads = std::min<int64_t>(nthreads, std::max<int64_t>(npairs, 1));
  auto work = [&](int t) {
    std::vector<uint64_t> peq, pv, mv;
    std::vector<int64_t> bscore;
    for (int64_t p = t; p < npairs; p += nthreads) {
      const int64_t i = ia[p], j = ib[p];
      out[p] = myers_auto(seqs + offsets[i], offsets[i + 1] - offsets[i],
                          seqs + offsets[j], offsets[j + 1] - offsets[j],
                          peq, pv, mv, bscore);
    }
  };
  if (nthreads == 1) {
    work(0);
    return;
  }
  std::vector<std::thread> ts;
  for (int t = 0; t < nthreads; ++t) ts.emplace_back(work, t);
  for (auto &th : ts) th.join();
}

int64_t myers_one(const uint8_t *a, int64_t la, const uint8_t *b, int64_t lb) {
  std::vector<uint64_t> peq, pv, mv;
  std::vector<int64_t> bscore;
  return myers_auto(a, la, b, lb, peq, pv, mv, bscore);
}

// unbanded reference for validation
int64_t myers_one_full(const uint8_t *a, int64_t la, const uint8_t *b,
                       int64_t lb) {
  std::vector<uint64_t> peq;
  return myers_distance(a, la, b, lb, peq);
}

}  // extern "C"
