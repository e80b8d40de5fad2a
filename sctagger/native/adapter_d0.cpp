// Host exact-adapter (dist-0) scan for stage 1 (models/adapter.py).
//
// Every read the host decides skips the 2-bit pack, the host->device upload
// (~505 MB per 1M x 2kbp reads) and the device scan. A read with an EXACT
// adapter occurrence on exactly
// one strand is fully decidable on the host (reference scTagger.py:176-196:
// d1 < d2 with d = 0, all optimal end locations = the exact occurrence
// ends; for the '-' strand each optimal start is exactly end - m + 1 at
// distance 0), and a read with exact hits on BOTH strands is the d1 == d2
// tie => NA. Such reads never need to ship to the device at all.
//
// One rolling pass per read computes both strands: a 2-bit packed key of
// the last m chars (m <= 32) compared against the packed adapter and
// revcomp-adapter keys, with a last-junk tracker so windows containing
// non-ACGT bytes never match (STRICT semantics — edlib treats 'N'/'a' as
// mismatches). ~4 ops/char, threads split the read range statically:
// about 1 GB/s per core.

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

struct D0Args {
    const uint8_t* buf;
    const int64_t* offs;
    const uint8_t* table;  // 256-byte code table: 0..3 = ACGT, >3 = junk
    uint64_t key_fwd, key_rc, mask;
    int m;
    int kmax;
    int32_t* fwd_cnt;
    int32_t* rc_cnt;
    int64_t* ends;  // (n, 2*kmax): [0,kmax) fwd ends, [kmax,2*kmax) rc ends
};

void scan_span(const D0Args& a, int64_t r0, int64_t r1) {
    for (int64_t r = r0; r < r1; r++) {
        const uint8_t* p = a.buf + a.offs[r];
        int64_t len = a.offs[r + 1] - a.offs[r];
        int64_t* fe = a.ends + r * 2 * a.kmax;
        int64_t* re = fe + a.kmax;
        int32_t fc = 0, rc = 0;
        uint64_t key = 0;
        int64_t last_bad = -1;
        for (int64_t j = 0; j < len; j++) {
            uint8_t c = a.table[p[j]];
            key = ((key << 2) | (c & 3)) & a.mask;
            if (c > 3) last_bad = j;
            if (j >= a.m - 1 && last_bad <= j - a.m) {
                if (key == a.key_fwd) {
                    if (fc < a.kmax) fe[fc] = j;
                    fc++;
                }
                if (key == a.key_rc) {
                    if (rc < a.kmax) re[rc] = j;
                    rc++;
                }
            }
        }
        a.fwd_cnt[r] = fc;
        a.rc_cnt[r] = rc;
    }
}

}  // namespace

extern "C" {

// All outputs caller-allocated: fwd_cnt/rc_cnt int32[n], ends int64[n*2*kmax]
// (only the first cnt slots per strand are written; counts may exceed kmax).
// key_fwd/key_rc: 2-bit packed adapter / revcomp-adapter (char 0 in the top
// bits, exactly ops/exact_prefilter._pattern_keys). m <= 32.
void sctag_adapter_d0(const uint8_t* buf, const int64_t* offs, int64_t n,
                      const uint8_t* table, uint64_t key_fwd, uint64_t key_rc,
                      int m, int kmax, int nthreads, int32_t* fwd_cnt,
                      int32_t* rc_cnt, int64_t* ends) {
    uint64_t mask =
        (m >= 32) ? ~0ull : ((1ull << (2 * m)) - 1);
    D0Args a{buf, offs, table, key_fwd, key_rc, mask,
             m, kmax, fwd_cnt, rc_cnt, ends};
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
