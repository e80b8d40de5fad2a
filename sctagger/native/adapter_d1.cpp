// Host dist<=1 adapter scan for stage 1 (models/adapter.py).
//
// Extends the d0 exact scan (adapter_d0.cpp) to single-edit occurrences: a
// read whose adapter min-distance is 0 OR 1 on exactly one strand (and
// whose full optimal-location set fits the slot budget) is fully decidable
// host-side and never ships to the device — at ~1% per-base error most
// reads carry a 0- or 1-edit adapter, so this removes nearly all of the
// upload and device work.
//
// Method: pigeonhole screen + exact verify.
//   * Screen: split the m-char pattern P = A·B (|A| = m/2). Any occurrence
//     with <= 1 edit contains an EXACT occurrence of A or B (the single
//     edit lies in one half; the other half is intact). One rolling 2-bit
//     key register per read position serves all four half keys (fwd A/B,
//     revcomp A/B) — 4 masked compares per char, no hashing.
//   * Candidates: a B-half hit ending at j implies a candidate occurrence
//     END j (the edit is in the A region, which never moves the end); an
//     A-half hit ending at j implies candidate ends j+|B|-1, j+|B|, j+|B|+1
//     (deletion / substitution / insertion in the B region).
//   * Verify (exact, per candidate end j): global edit distance of P vs the
//     windows of length m-1/m/m+1 ending at j via prefix/suffix compare
//     (dist 1 iff lcp+lcs >= m-1 / one substitution / lcp+lcs >= m). Exact
//     edlib semantics: per-char equality through the STRICT code table, so
//     non-ACGT bytes mismatch everything — which also makes a single junk
//     byte inside the window a legal substitution edit, exactly as edlib
//     scores it. HW end-position sets are therefore EXACT:
//       dist_j = min over window lengths {m-1, m, m+1} ending at j
//     (a <= 1-edit alignment cannot consume any other window length).
//   * Reverse-strand starts: for an end j at distance 1 the reported start
//     is the MINIMAL optimal start (edlib's reverse-SHW furthest position,
//     scTagger.py:189 / models/adapter.py docstring) = j - L* + 1 where L*
//     is the LARGEST window length in {m+1, m, m-1} at edit distance 1
//     (distance 0 cannot occur for a read whose min is 1). Starts are
//     emitted directly, in ascending-end order.
//
// Completeness of the screen (why no dist<=1 end can be missed): write the
// edited window w as P with one edit at pattern position p (or gap g for
// insertions). If p < |A| (or g <= |A|), B occurs exactly at the window
// end => B fires at j. Otherwise A occurs exactly at the window start =>
// A fires at j - |B| -/+ the length shift => one of the three A-derived
// candidates is j. Junk-byte edits are covered because the OTHER half
// contains no edit and no junk (a junk byte would itself be the edit).
//
// Outputs per read: d0 and d1 location counts per strand plus up to kmax
// slots each (fwd: end positions; rc d0: end positions; rc d1: starts),
// and a flags byte (bit0 = candidate overflow => caller must defer the
// read to the device path). Counts may exceed kmax (caller defers).

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

#include "adapter_verify.h"

namespace {

struct Pat {
    uint8_t codes[32];
    int m, h1, h2;
    uint64_t key_a, key_b, mask_a, mask_b;
};

void build_pat(const uint8_t* codes, int m, Pat& p) {
    std::memcpy(p.codes, codes, (size_t)m);
    p.m = m;
    p.h1 = m / 2;
    p.h2 = m - p.h1;
    p.key_a = p.key_b = 0;
    for (int i = 0; i < p.h1; i++) p.key_a = (p.key_a << 2) | codes[i];
    for (int i = p.h1; i < m; i++) p.key_b = (p.key_b << 2) | codes[i];
    p.mask_a = (1ull << (2 * p.h1)) - 1;
    p.mask_b = (p.h2 >= 32) ? ~0ull : ((1ull << (2 * p.h2)) - 1);
}

// Exact <=1-edit verdict for pattern vs the window ending at j (inclusive):
// the shared sctag_verify_le1 (adapter_verify.h, ONE home for the d<=1
// semantics across the d1 and d2 scanners).
inline int verify_end(const uint8_t* t, int64_t len, const uint8_t* table,
                      const Pat& P, int64_t j, int* lstar) {
    (void)len;
    return sctag_verify_le1(t, table, P.codes, P.m, j, lstar);
}

constexpr int CAND_CAP = 96;

struct D1Args {
    const uint8_t* buf;
    const int64_t* offs;
    const uint8_t* table;
    Pat pf, pr;
    int kmax;
    int32_t *f0, *r0, *f1, *r1;
    int64_t *ends0, *ends1;
    uint8_t* flags;
};

void scan_read(const D1Args& a, int64_t r) {
    const uint8_t* p = a.buf + a.offs[r];
    const int64_t len = a.offs[r + 1] - a.offs[r];
    const Pat& PF = a.pf;
    const Pat& PR = a.pr;
    const int m = PF.m;
    int64_t cf[CAND_CAP], cr[CAND_CAP];
    int ncf = 0, ncr = 0;
    bool ovf = false;
    uint64_t reg = 0;
    const uint8_t* tab = a.table;
    for (int64_t j = 0; j < len; j++) {
        reg = (reg << 2) | (tab[p[j]] & 3);
        // half-key screen: 4 masked compares; junk bytes alias into the
        // 2-bit alphabet here, so a fire is only a CANDIDATE (the verify
        // re-checks through the full table) and a genuine exact half can
        // never be missed
        uint64_t xa = reg & PF.mask_a;  // PF/PR share h1,h2 (same m)
        uint64_t xb = reg & PF.mask_b;
        bool fa = xa == PF.key_a, fb = xb == PF.key_b;
        bool ra = xa == PR.key_a, rb = xb == PR.key_b;
        if (!(fa | fb | ra | rb)) continue;
        auto push = [&](int64_t* c, int& n, int64_t e) {
            if (e < m - 2 || e >= len) return;
            if (n < CAND_CAP) c[n++] = e;
            else ovf = true;
        };
        if (fb) push(cf, ncf, j);
        if (fa) {
            push(cf, ncf, j + PF.h2 - 1);
            push(cf, ncf, j + PF.h2);
            push(cf, ncf, j + PF.h2 + 1);
        }
        if (rb) push(cr, ncr, j);
        if (ra) {
            push(cr, ncr, j + PR.h2 - 1);
            push(cr, ncr, j + PR.h2);
            push(cr, ncr, j + PR.h2 + 1);
        }
    }
    a.flags[r] = ovf ? 1 : 0;
    if (ovf) {  // counts stay 0: the caller defers the read to the device
        a.f0[r] = a.r0[r] = a.f1[r] = a.r1[r] = 0;
        return;
    }
    int64_t* e0 = a.ends0 + r * 2 * a.kmax;
    int64_t* e1 = a.ends1 + r * 2 * a.kmax;
    int c0, c1;
    // forward strand: ends for d0 and d1
    std::sort(cf, cf + ncf);
    c0 = c1 = 0;
    for (int i = 0; i < ncf; i++) {
        if (i && cf[i] == cf[i - 1]) continue;
        int lstar;
        int d = verify_end(p, len, tab, PF, cf[i], &lstar);
        if (d == 0) {
            if (c0 < a.kmax) e0[c0] = cf[i];
            c0++;
        } else if (d == 1) {
            if (c1 < a.kmax) e1[c1] = cf[i];
            c1++;
        }
    }
    a.f0[r] = c0;
    a.f1[r] = c1;
    // reverse strand: d0 ends; d1 starts (= end - L* + 1), ascending-end
    std::sort(cr, cr + ncr);
    c0 = c1 = 0;
    for (int i = 0; i < ncr; i++) {
        if (i && cr[i] == cr[i - 1]) continue;
        int lstar;
        int d = verify_end(p, len, tab, PR, cr[i], &lstar);
        if (d == 0) {
            if (c0 < a.kmax) e0[a.kmax + c0] = cr[i];
            c0++;
        } else if (d == 1) {
            if (c1 < a.kmax) e1[a.kmax + c1] = cr[i] - lstar + 1;
            c1++;
        }
    }
    a.r0[r] = c0;
    a.r1[r] = c1;
}

void scan_span(const D1Args& a, int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1; r++) scan_read(a, r);
}

}  // namespace

extern "C" {

// All outputs caller-allocated: f0/r0/f1/r1 int32[n], ends0/ends1
// int64[n*2*kmax] ([0,kmax) fwd | [kmax,2*kmax) rc), flags uint8[n].
// pat_fwd/pat_rc: m uint8 codes in 0..3 (the caller rejects junk adapters).
// ends0: d0 END positions both strands. ends1: fwd d1 END positions; rc d1
// START positions (minimal optimal start per end), ascending-end order.
// flags bit0: candidate overflow — treat the read as undecided.
// Requires 4 <= m <= 32.
void sctag_adapter_scan1(const uint8_t* buf, const int64_t* offs, int64_t n,
                         const uint8_t* table, const uint8_t* pat_fwd,
                         const uint8_t* pat_rc, int m, int kmax, int nthreads,
                         int32_t* f0, int32_t* r0, int32_t* f1, int32_t* r1,
                         int64_t* ends0, int64_t* ends1, uint8_t* flags) {
    D1Args a;
    a.buf = buf;
    a.offs = offs;
    a.table = table;
    build_pat(pat_fwd, m, a.pf);
    build_pat(pat_rc, m, a.pr);
    a.kmax = kmax;
    a.f0 = f0;
    a.r0 = r0;
    a.f1 = f1;
    a.r1 = r1;
    a.ends0 = ends0;
    a.ends1 = ends1;
    a.flags = flags;
    if (nthreads < 1) nthreads = 1;
    if (nthreads == 1 || n < 1024) {
        scan_span(a, 0, n);
        return;
    }
    std::vector<std::thread> pool;
    int64_t per = (n + nthreads - 1) / nthreads;
    for (int t = 1; t < nthreads; t++) {
        int64_t s = per * t;
        if (s >= n) break;
        int64_t e = s + per < n ? s + per : n;
        pool.emplace_back([&a, s, e] { scan_span(a, s, e); });
    }
    scan_span(a, 0, per < n ? per : n);
    for (auto& t : pool) t.join();
}

}  // extern "C"
