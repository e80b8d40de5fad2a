// Reference-class native oracles for HONEST baseline measurement and
// independent cross-checking.
//
// The reference (vpc-ccg/scTagger) gets its speed from C/C++ extension
// libraries that are not installable here (no network): edlib (Myers
// bit-vector edit distance) and pyahocorasick (Aho-Corasick automaton).
// Measuring the reference script against pure-Python functional stubs would
// overstate our speedups, so this file provides from-scratch C++
// implementations in the same performance class, exposed over a C ABI and
// injected into the reference process as functional edlib/ahocorasick
// modules (tests/refharness.py). They are written from the published
// algorithms (Myers 1999 bit-vector; Aho-Corasick 1975), NOT translated
// from edlib/pyahocorasick sources.
//
// Semantics mirrored (documented in tests/oracle.py, derived from the
// reference's observable surface at scTagger.py:180-196, 801-826):
//   * HW ("infix") mode: D[0][j] = 0, answer = min_j D[m][j]; one location
//     per optimal end, start = end - (furthest optimal position of the
//     reverse-SHW pass over the reversed prefix).
//   * SHW ("prefix") mode: D[0][j] = j (leading text gap penalized),
//     realized by the carry-in bit on Ph's shift.
//   * Aho-Corasick: every (end_index, value) occurrence in end order,
//     longer words before their shorter suffixes at the same end;
//     re-adding a word overwrites its value.

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <thread>
#include <vector>

namespace {

// ---------------------------------------------------------------------------
// Myers bit-vector (single uint64 word, pattern length <= 64)
// ---------------------------------------------------------------------------

struct Peq256 {
  uint64_t eq[256];
};

static void build_peq(const uint8_t* q, int m, Peq256* p) {
  memset(p->eq, 0, sizeof(p->eq));
  for (int i = 0; i < m; i++) p->eq[q[i]] |= 1ull << i;
}

// One column update; returns new score. shw selects the +1 carry-in at the
// top row (prefix mode).
static inline int myers_col(uint64_t& pv, uint64_t& mv, int score,
                            uint64_t eq, uint64_t high, bool shw) {
  uint64_t xv = eq | mv;
  uint64_t xh = (((eq & pv) + pv) ^ pv) | eq;
  uint64_t ph = mv | ~(xh | pv);
  uint64_t mh = pv & xh;
  if (ph & high) score++;
  if (mh & high) score--;
  ph <<= 1;
  if (shw) ph |= 1ull;
  mh <<= 1;
  pv = mh | ~(xv | ph);
  mv = ph & xv;
  return score;
}

// Furthest position k in [0, n) with SHW score == target, scanning the
// (already reversed) pattern Peq against the (already reversed) text;
// -1 if never reached (cannot happen for a valid HW end).
static int64_t shw_last_at(const Peq256& p, int m, const uint8_t* t,
                           int64_t n, int target) {
  uint64_t pv = ~0ull, mv = 0, high = 1ull << (m - 1);
  int score = m;
  int64_t last = -1;
  for (int64_t j = 0; j < n; j++) {
    score = myers_col(pv, mv, score, p.eq[t[j]], high, /*shw=*/true);
    if (score == target) last = j;
  }
  return last;
}

}  // namespace

extern "C" {

void sctag_ref_free(void* ptr) { free(ptr); }

// edlib.align(query, target, 'HW', 'locations') equivalent.
// Returns 0 on success; out_locs is a malloc'd array of 2*n_locs int64
// (start, end) pairs ordered by end; caller frees with sctag_ref_free.
// Empty target => dist = m, no locations (matches tests/oracle.py).
int sctag_ref_hw_locations(const uint8_t* query, int m, const uint8_t* target,
                           int64_t n, int* out_dist, int64_t** out_locs,
                           int64_t* out_nlocs) {
  *out_locs = nullptr;
  *out_nlocs = 0;
  if (m <= 0 || m > 64) return -1;
  *out_dist = m;
  if (n <= 0) return 0;

  Peq256 p;
  build_peq(query, m, &p);
  uint64_t pv = ~0ull, mv = 0, high = 1ull << (m - 1);
  int score = m;
  int best = m + 1;
  std::vector<int64_t> ends;
  for (int64_t j = 0; j < n; j++) {
    score = myers_col(pv, mv, score, p.eq[target[j]], high, /*shw=*/false);
    if (score < best) {
      best = score;
      ends.clear();
      ends.push_back(j);
    } else if (score == best) {
      ends.push_back(j);
    }
  }
  *out_dist = best;

  // start recovery per optimal end: reverse SHW over the reversed prefix
  Peq256 pr;
  {
    std::vector<uint8_t> qr(m);
    for (int i = 0; i < m; i++) qr[i] = query[m - 1 - i];
    build_peq(qr.data(), m, &pr);
  }
  int64_t* locs = (int64_t*)malloc(sizeof(int64_t) * 2 * ends.size());
  if (!locs) return -2;
  std::vector<uint8_t> rbuf;
  for (size_t i = 0; i < ends.size(); i++) {
    int64_t e = ends[i];
    rbuf.assign(e + 1, 0);
    for (int64_t j = 0; j <= e; j++) rbuf[j] = target[e - j];
    int64_t k = shw_last_at(pr, m, rbuf.data(), e + 1, best);
    locs[2 * i] = (k < 0) ? 0 : e - k;
    locs[2 * i + 1] = e;
  }
  *out_locs = locs;
  *out_nlocs = (int64_t)ends.size();
  return 0;
}

// Dense stage-3 match oracle: for every segment r (codes 0..3 = ACGT, any
// other code matches nothing, first lens[r] of ls columns valid) and every
// pattern p (codes, length m <= 64) the best infix edit distance; writes
// out[0][r] = min over patterns, out[1][r] = number of patterns at that min,
// out[2 + t][r] = the t-th such pattern id ascending (1 << 28 when fewer
// than k). out is (k + 2) x R int32, row-major. Segments are split over
// nthreads threads.
int sctag_ref_match_full(const uint8_t* segs, const int32_t* lens, int64_t R,
                         int64_t ls, const uint8_t* pats, int64_t P, int m,
                         int k, int32_t* out, int nthreads) {
  if (m <= 0 || m > 64 || k < 0) return -1;
  std::vector<uint64_t> peq((size_t)P * 4, 0);
  for (int64_t p = 0; p < P; p++)
    for (int i = 0; i < m; i++) {
      uint8_t c = pats[p * m + i];
      if (c < 4) peq[p * 4 + c] |= 1ull << i;
    }
  const uint64_t high = 1ull << (m - 1);
  auto work = [&](int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1; r++) {
      const uint8_t* t = segs + r * ls;
      int64_t n = lens[r] < ls ? lens[r] : ls;
      int dmin = m + 1, cnt = 0;
      std::vector<int32_t> first;
      for (int64_t p = 0; p < P; p++) {
        uint64_t pv = ~0ull, mv = 0;
        int score = m, best = m;
        for (int64_t j = 0; j < n; j++) {
          uint64_t eq = t[j] < 4 ? peq[p * 4 + t[j]] : 0;
          score = myers_col(pv, mv, score, eq, high, /*shw=*/false);
          if (score < best) best = score;
        }
        if (best < dmin) {
          dmin = best;
          cnt = 0;
          first.clear();
        }
        if (best == dmin) {
          cnt++;
          if ((int)first.size() < k) first.push_back((int32_t)p);
        }
      }
      out[r] = dmin;
      out[R + r] = cnt;
      for (int i = 0; i < k; i++)
        out[(2 + i) * R + r] = i < (int)first.size() ? first[i] : (1 << 28);
    }
  };
  if (nthreads < 1) nthreads = 1;
  std::vector<std::thread> pool;
  int64_t step = (R + nthreads - 1) / nthreads;
  for (int64_t r0 = 0; r0 < R; r0 += step)
    pool.emplace_back(work, r0, r0 + step < R ? r0 + step : R);
  for (auto& th : pool) th.join();
  return 0;
}

// ---------------------------------------------------------------------------
// Aho-Corasick automaton (ACGT alphabet, arbitrary-length words)
// ---------------------------------------------------------------------------

struct AcNode {
  int32_t ch[4];
  int32_t fail;
  int32_t out_link;  // nearest word node on the fail chain (incl. self), -1
  int64_t value;
  uint8_t is_word;
  int32_t depth;
};

struct AcAuto {
  std::vector<AcNode> nodes;
  bool built = false;
  int8_t code[256];
  AcAuto() {
    memset(code, -1, sizeof(code));
    code[(int)'A'] = 0;
    code[(int)'C'] = 1;
    code[(int)'G'] = 2;
    code[(int)'T'] = 3;
    nodes.push_back(AcNode{{-1, -1, -1, -1}, 0, -1, 0, 0, 0});
  }
};

void* sctag_ac_create() { return new AcAuto(); }

void sctag_ac_destroy(void* h) { delete (AcAuto*)h; }

// Returns 0 on success, -1 on a non-ACGT character (reference words are
// always ACGT barcodes). Re-adding a word overwrites its value.
int sctag_ac_add(void* h, const uint8_t* word, int len, int64_t value) {
  AcAuto* a = (AcAuto*)h;
  int32_t cur = 0;
  for (int i = 0; i < len; i++) {
    int c = a->code[word[i]];
    if (c < 0) return -1;
    int32_t nxt = a->nodes[cur].ch[c];
    if (nxt < 0) {
      nxt = (int32_t)a->nodes.size();
      a->nodes.push_back(
          AcNode{{-1, -1, -1, -1}, 0, -1, 0, 0, a->nodes[cur].depth + 1});
      a->nodes[cur].ch[c] = nxt;
    }
    cur = nxt;
  }
  a->nodes[cur].is_word = 1;
  a->nodes[cur].value = value;
  return 0;
}

int64_t sctag_ac_size(void* h) { return (int64_t)((AcAuto*)h)->nodes.size(); }

// BFS: fail links + goto completion (missing edges rewired to the fail
// target's edge, making every scan step O(1)) + output links.
int sctag_ac_build(void* h) {
  AcAuto* a = (AcAuto*)h;
  std::vector<int32_t> queue;
  queue.reserve(a->nodes.size());
  for (int c = 0; c < 4; c++) {
    int32_t v = a->nodes[0].ch[c];
    if (v < 0) {
      a->nodes[0].ch[c] = 0;
    } else {
      a->nodes[v].fail = 0;
      queue.push_back(v);
    }
  }
  for (size_t qi = 0; qi < queue.size(); qi++) {
    int32_t u = queue[qi];
    int32_t f = a->nodes[u].fail;
    a->nodes[u].out_link =
        a->nodes[f].is_word ? f : a->nodes[f].out_link;
    for (int c = 0; c < 4; c++) {
      int32_t v = a->nodes[u].ch[c];
      int32_t ff = a->nodes[f].ch[c];
      if (v < 0) {
        a->nodes[u].ch[c] = ff;
      } else {
        a->nodes[v].fail = ff;
        queue.push_back(v);
      }
    }
  }
  a->built = true;
  return 0;
}

// Scan: writes up to cap (end_index, value) pairs in pyahocorasick order
// (by end; longer word before its shorter suffixes at the same end) and
// returns the TOTAL occurrence count (callers detect truncation by
// total > cap). Non-ACGT haystack chars reset to the root.
int64_t sctag_ac_iter(void* h, const uint8_t* hay, int64_t n, int64_t* ends,
                      int64_t* values, int64_t cap) {
  AcAuto* a = (AcAuto*)h;
  if (!a->built) return -1;
  const AcNode* nodes = a->nodes.data();
  int32_t cur = 0;
  int64_t total = 0;
  for (int64_t j = 0; j < n; j++) {
    int c = a->code[hay[j]];
    cur = (c < 0) ? 0 : nodes[cur].ch[c];
    int32_t w = nodes[cur].is_word ? cur : nodes[cur].out_link;
    while (w >= 0) {
      if (total < cap) {
        ends[total] = j;
        values[total] = nodes[w].value;
      }
      total++;
      w = nodes[w].out_link;
    }
  }
  return total;
}

}  // extern "C"
