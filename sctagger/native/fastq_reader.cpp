// Native host-ingest path for FASTQ: gzip/plain decode + record parsing
// + batch 2-bit-code packing, replacing the Python-loop reader for the
// stage-1 hot path (reference read_fastqs, scTagger.py:159-173).
//
// Parsing reproduces the reference's text semantics exactly:
//   * per file, line index counts from 0; line%4==0 is the header, line%4==1
//     the sequence, other lines ignored;
//   * header name = first whitespace-delimited token minus its first char
//     (Python `l.split()[0][1:]`) — leading whitespace skipped, token may be
//     just "@" (empty name); an all-whitespace header is an error (the
//     Python reader raises IndexError there);
//   * sequence = line with TRAILING whitespace stripped (Python l.rstrip());
//     leading whitespace is kept;
//   * universal newlines: lines end at '\n', '\r', or "\r\n" (Python 'rt'
//     mode); a final line without a terminator still counts.
//
// gzopen reads both gzip and plain files transparently, so one path serves
// the reference's `gzipped or name.endswith('.gz')` rule and plain files.
//
// Build: part of libsctag_io.so (see build.py).

#include <cctype>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <zlib.h>

namespace {

// calloc-backed growable byte buffer: on this host's kernel, first-touch
// writes to plain-malloc pages run ~500us/page while calloc-backed pages
// write at GB/s (see CLAUDE.md page-fault cliff) — a 100MB parse output is
// seconds vs milliseconds. The final pointer is handed to the caller
// (freed with sctag_free == free).
struct Buf {
    char* p = nullptr;
    size_t n = 0, cap = 0;

    ~Buf() { std::free(p); }

    void reserve(size_t c) {
        if (c <= cap) return;
        char* q = (char*)std::calloc(c, 1);
        if (n) std::memcpy(q, p, n);
        std::free(p);
        p = q;
        cap = c;
    }

    void append(const char* s, size_t k) {
        if (n + k > cap) {
            size_t want = n + k;
            size_t dbl = cap ? cap * 2 : (size_t)1 << 20;
            reserve(want > dbl ? want : dbl);
        }
        std::memcpy(p + n, s, k);
        n += k;
    }

    void push_back(char c) { append(&c, 1); }

    char* release() {  // hand ownership to the caller; never null
        if (!p) p = (char*)std::calloc(1, 1);
        char* q = p;
        p = nullptr;
        n = cap = 0;
        return q;
    }
};

struct FastqOut {
    Buf names;                    // '\n'-joined (trailing '\n' per name)
    Buf seqs;                     // concatenated, no separators
    std::vector<int64_t> offs;    // n_seqs + 1 offsets into seqs
    int64_t n_names = 0;
    int64_t n_lines = 0;          // total lines (records = n_lines / 4)
    int64_t names_done = 0;       // bytes of names covering COMPLETE records
    std::string error;
};

inline bool is_ws(unsigned char c) {
    return c == ' ' || c == '\t' || c == '\n' || c == '\v' || c == '\f' ||
           c == '\r';
}

class FastqParser {
  public:
    explicit FastqParser(FastqOut& out) : out_(out) { out_.offs.push_back(0); }

    // memchr-based bulk scan: whole lines are processed straight out of the
    // read chunk (no per-char copy; the spill buffer is used only for lines
    // crossing chunk boundaries). The '\r' search is bounded by the next
    // '\n' so CR-less files never rescan.
    bool feed(const char* data, size_t n) {
        size_t i = 0;
        if (prev_cr_) {
            prev_cr_ = false;
            if (n > 0 && data[0] == '\n') i = 1;  // "\r\n" across chunks
        }
        while (i < n) {
            const char* nl = (const char*)memchr(data + i, '\n', n - i);
            size_t lim = nl ? (size_t)(nl - (data + i)) : n - i;
            const char* cr = (const char*)memchr(data + i, '\r', lim);
            const char* term = cr ? cr : nl;
            if (!term) {  // no terminator in this chunk: stash the tail
                line_.append(data + i, n - i);
                return true;
            }
            size_t end = (size_t)(term - data);
            bool ok;
            if (line_.empty()) {
                ok = process_line(data + i, end - i);
            } else {
                line_.append(data + i, end - i);
                ok = process_line(line_.data(), line_.size());
                line_.clear();
            }
            if (!ok) return false;
            i = end + 1;
            if (*term == '\r') {
                if (i < n) {
                    if (data[i] == '\n') i++;
                } else {
                    prev_cr_ = true;  // possible "\r\n" split across chunks
                }
            }
        }
        return true;
    }

    bool eof() {
        if (!line_.empty()) {
            bool ok = process_line(line_.data(), line_.size());
            line_.clear();
            return ok;
        }
        return true;
    }

  private:
    bool process_line(const char* l, size_t n) {
        int r = line_idx_ & 3;
        if (r == 0) {
            size_t i = 0;
            while (i < n && is_ws((unsigned char)l[i])) i++;
            size_t start = i;
            while (i < n && !is_ws((unsigned char)l[i])) i++;
            if (i == start) {
                out_.error = "malformed header line (no token)";
                return false;
            }
            // token minus its first char, exactly `l.split()[0][1:]`
            out_.names.append(l + start + 1, i - start - 1);
            out_.names.push_back('\n');
            out_.n_names++;
        } else if (r == 1) {
            size_t j = n;
            while (j > 0 && is_ws((unsigned char)l[j - 1])) j--;
            out_.seqs.append(l, j);
            out_.offs.push_back((int64_t)out_.seqs.n);
            out_.names_done = (int64_t)out_.names.n;  // record complete
        }
        line_idx_++;
        out_.n_lines = line_idx_;
        return true;
    }

    FastqOut& out_;
    std::string line_;  // spill for lines crossing chunk boundaries
    int64_t line_idx_ = 0;
    bool prev_cr_ = false;
};

char* dup_malloc(const std::string& s) {
    char* p = (char*)std::malloc(s.size() + 1);
    std::memcpy(p, s.data(), s.size() + 1);
    return p;
}

}  // namespace

extern "C" {

// Parse one FASTQ file (gzip or plain, auto-detected by zlib). Returns 0 on
// success; on failure *error holds a malloc'd message. All output buffers are
// malloc'd; free each with sctag_free.
//   names_buf : '\n'-terminated name per header line (n_names entries)
//   seq_buf   : concatenated sequence bytes
//   seq_offs  : n_seqs + 1 int64 offsets into seq_buf
int sctag_read_fastq(const char* path, char** names_buf, int64_t* names_len,
                     int64_t* n_names, char** seq_buf, int64_t** seq_offs,
                     int64_t* n_seqs, int64_t* n_lines, char** error) {
    *names_buf = nullptr;
    *seq_buf = nullptr;
    *seq_offs = nullptr;
    *names_len = *n_names = *n_seqs = *n_lines = 0;
    *error = nullptr;

    FastqOut out;
    bool gz = false;
    {
        // magic sniff + pre-size the big outputs from the file size
        // (sequences are ~half the text; gzip FASTQ compresses ~3-4x) —
        // growth doubling still covers misestimates, this just skips most
        // of the copies
        FILE* sf = std::fopen(path, "rb");
        if (!sf) {
            *error = dup_malloc("cannot open file");
            return 1;
        }
        std::fseek(sf, 0, SEEK_END);
        long sz = std::ftell(sf);
        unsigned char magic[2] = {0, 0};
        std::fseek(sf, 0, SEEK_SET);
        size_t got = std::fread(magic, 1, 2, sf);
        std::fclose(sf);
        gz = got == 2 && magic[0] == 0x1f && magic[1] == 0x8b;
        if (sz > 0) {
            size_t text = (size_t)sz * (gz ? 4 : 1);
            out.seqs.reserve(text / 2 + 4096);
            out.names.reserve(text / 32 + 4096);
        }
    }
    FastqParser parser(out);
    std::vector<char> chunk(1 << 22);
    bool ok = true;
    if (!gz) {
        // plain file: raw fread — zlib's transparent mode copies every byte
        // through its internal window (~230 MB/s measured on a 2 GB FASTQ);
        // the direct path parses straight from page cache
        FILE* f = std::fopen(path, "rb");
        if (!f) {
            *error = dup_malloc("cannot open file");
            return 1;
        }
        for (;;) {
            size_t got = std::fread(chunk.data(), 1, chunk.size(), f);
            if (got == 0) {
                if (std::ferror(f)) {
                    out.error = "read error";
                    ok = false;
                }
                break;
            }
            if (!parser.feed(chunk.data(), got)) {
                ok = false;
                break;
            }
        }
        std::fclose(f);
    } else {
        gzFile f = gzopen(path, "rb");
        if (!f) {
            *error = dup_malloc("cannot open file");
            return 1;
        }
        gzbuffer(f, 1 << 20);
        for (;;) {
            int got = gzread(f, chunk.data(), (unsigned)chunk.size());
            if (got < 0) {
                out.error = "gzip read error";
                ok = false;
                break;
            }
            if (got == 0) break;
            if (!parser.feed(chunk.data(), (size_t)got)) {
                ok = false;
                break;
            }
        }
        gzclose(f);
    }
    if (ok) ok = parser.eof();
    if (!ok) {
        *error = dup_malloc(out.error);
        return 1;
    }

    *names_len = (int64_t)out.names.n;
    *names_buf = out.names.release();  // calloc-backed; caller sctag_free's
    *n_names = out.n_names;
    *n_lines = out.n_lines;
    *n_seqs = (int64_t)out.offs.size() - 1;
    *seq_buf = out.seqs.release();
    *seq_offs =
        (int64_t*)std::calloc(out.offs.size(), sizeof(int64_t));
    std::memcpy(*seq_offs, out.offs.data(), sizeof(int64_t) * out.offs.size());
    return 0;
}

// Encode selected rows of a flat sequence buffer into a padded code matrix:
// out[i, j] = table[seq_buf[offs[idx[i]] + j]] for j < row_len, pad_code
// after. out must hold n_idx * pad_to bytes; rows longer than pad_to are the
// caller's error to prevent (mirrors core.packing.encode_seqs).
void sctag_encode_rows(const char* seq_buf, const int64_t* offs,
                       const int64_t* idx, int64_t n_idx,
                       const unsigned char* table, unsigned char pad_code,
                       int64_t pad_to, unsigned char* out) {
    for (int64_t i = 0; i < n_idx; i++) {
        int64_t o0 = offs[idx[i]];
        int64_t len = offs[idx[i] + 1] - o0;
        if (len > pad_to) len = pad_to;
        unsigned char* dst = out + i * pad_to;
        const unsigned char* src = (const unsigned char*)seq_buf + o0;
        for (int64_t j = 0; j < len; j++) dst[j] = table[src[j]];
        if (len < pad_to) std::memset(dst + len, pad_code, (size_t)(pad_to - len));
    }
}

// Encode + 2-bit pack selected rows for the adapter scan's packed upload
// (ops/adapter_scan.py): char j of row i lands in
// out[i*(pad_to/4) + (j>>2)] at bits 2*(j&3), as table[c] & 3 (so the junk
// code 4 aliases to 'A' — the scan's contract excludes junk rows).
// junk_out[i] = 1 iff any in-sequence char maps to a code >= 4, letting the
// caller route those rows to the exact unpacked fallback. pad_to % 4 == 0.
void sctag_encode_rows_packed(const char* seq_buf, const int64_t* offs,
                              const int64_t* idx, int64_t n_idx,
                              const unsigned char* table, int64_t pad_to,
                              unsigned char* out, unsigned char* junk_out) {
    int64_t lq = pad_to / 4;
    for (int64_t i = 0; i < n_idx; i++) {
        int64_t o0 = offs[idx[i]];
        int64_t len = offs[idx[i] + 1] - o0;
        if (len > pad_to) len = pad_to;
        const unsigned char* src = (const unsigned char*)seq_buf + o0;
        unsigned char* dst = out + i * lq;
        unsigned int junk = 0;
        int64_t k = 0, full = len / 4;
        for (; k < full; k++) {
            unsigned c0 = table[src[4 * k]], c1 = table[src[4 * k + 1]];
            unsigned c2 = table[src[4 * k + 2]], c3 = table[src[4 * k + 3]];
            junk |= (c0 | c1 | c2 | c3) >> 2;
            dst[k] = (unsigned char)((c0 & 3) | ((c1 & 3) << 2) |
                                     ((c2 & 3) << 4) | ((c3 & 3) << 6));
        }
        if (k * 4 < len) {
            unsigned char b = 0;
            for (int64_t j = 4 * k; j < len; j++) {
                unsigned c = table[src[j]];
                junk |= c >> 2;
                b |= (unsigned char)((c & 3) << (2 * (j & 3)));
            }
            dst[k++] = b;
        }
        if (k < lq) std::memset(dst + k, 0, (size_t)(lq - k));
        junk_out[i] = junk ? 1 : 0;
    }
}

// Gather an arbitrary row subset into a compact buffer: out_buf gets the
// selected rows' bytes back to back, out_offs ((n_idx+1) int64) their new
// offsets. Caller pre-sizes out_buf to sum of selected lengths (numpy
// zeros-backed so first-touch writes stay fast — see CLAUDE.md page-fault
// cliff; the previous pure-numpy gather built ~600 MB of malloc-backed
// index temporaries and took ~50 s for 1M rows).
void sctag_gather_rows(const char* seq_buf, const int64_t* offs,
                       const int64_t* idx, int64_t n_idx, char* out_buf,
                       int64_t* out_offs) {
    int64_t pos = 0;
    out_offs[0] = 0;
    for (int64_t i = 0; i < n_idx; i++) {
        int64_t o0 = offs[idx[i]];
        int64_t len = offs[idx[i] + 1] - o0;
        std::memcpy(out_buf + pos, seq_buf + o0, (size_t)len);
        pos += len;
        out_offs[i + 1] = pos;
    }
}

// ---------------------------------------------------------------------------
// Incremental FASTQ stream: parse-in-batches so the caller can overlap host
// ingest with device dispatch (stage-1 pipeline). Emits COMPLETE
// (name, sequence) records only; a trailing header whose sequence line has
// not arrived yet is held back until it completes (or dropped at EOF — the
// drivers slice rnames[:len(seqs)] anyway, matching the reference's zip).
// ---------------------------------------------------------------------------

struct FastqStream {
    bool gz = false;
    FILE* f = nullptr;
    gzFile zf = nullptr;
    FastqOut out;
    FastqParser parser;
    std::vector<char> chunk;
    bool at_eof = false;

    FastqStream() : parser(out), chunk(1 << 22) {}
    ~FastqStream() {
        if (f) std::fclose(f);
        if (zf) gzclose(zf);
    }
};

// Open; returns nullptr with *error set on failure.
void* sctag_fastq_stream_open(const char* path, char** error) {
    *error = nullptr;
    FILE* sf = std::fopen(path, "rb");
    if (!sf) {
        *error = dup_malloc("cannot open file");
        return nullptr;
    }
    unsigned char magic[2] = {0, 0};
    size_t got = std::fread(magic, 1, 2, sf);
    bool gz = got == 2 && magic[0] == 0x1f && magic[1] == 0x8b;
    auto* st = new FastqStream();
    st->gz = gz;
    if (gz) {
        std::fclose(sf);
        st->zf = gzopen(path, "rb");
        if (!st->zf) {
            delete st;
            *error = dup_malloc("cannot open file");
            return nullptr;
        }
        gzbuffer(st->zf, 1 << 20);
    } else {
        std::fseek(sf, 0, SEEK_SET);
        st->f = sf;
    }
    return st;
}

// Parse until >= min_records COMPLETE records accumulated (or EOF), then
// emit them all: *names_buf = '\n'-joined names (malloc'd), *seq_buf =
// concatenated bytes (malloc'd), *seq_offs = (n_recs+1) int64 offsets from
// 0 (malloc'd). Returns 1 if any records emitted, 0 on clean EOF with none
// left, -1 on error (*error malloc'd). Free outputs with sctag_free.
int sctag_fastq_stream_next(void* h, int64_t min_records, char** names_buf,
                            int64_t* names_len, int64_t* n_recs,
                            char** seq_buf, int64_t** seq_offs, char** error) {
    auto* st = static_cast<FastqStream*>(h);
    *error = nullptr;
    *names_buf = nullptr;
    *seq_buf = nullptr;
    *seq_offs = nullptr;
    *names_len = *n_recs = 0;
    FastqOut& out = st->out;
    while (!st->at_eof &&
           (int64_t)out.offs.size() - 1 < (min_records < 1 ? 1 : min_records)) {
        size_t got;
        if (st->gz) {
            int g = gzread(st->zf, st->chunk.data(), (unsigned)st->chunk.size());
            if (g < 0) {
                *error = dup_malloc("gzip read error");
                return -1;
            }
            got = (size_t)g;
        } else {
            got = std::fread(st->chunk.data(), 1, st->chunk.size(), st->f);
            if (got == 0 && std::ferror(st->f)) {
                *error = dup_malloc("read error");
                return -1;
            }
        }
        if (got == 0) {
            st->at_eof = true;
            if (!st->parser.eof()) {
                *error = dup_malloc(out.error);
                return -1;
            }
            break;
        }
        if (!st->parser.feed(st->chunk.data(), got)) {
            *error = dup_malloc(out.error);
            return -1;
        }
    }
    int64_t k = (int64_t)out.offs.size() - 1;  // complete records buffered
    if (k == 0) return 0;
    // emit names [0, names_done), all recorded seqs, zero-based offsets
    int64_t nd = out.names_done;
    *names_buf = (char*)std::malloc((size_t)nd + 1);
    std::memcpy(*names_buf, out.names.p, (size_t)nd);
    (*names_buf)[nd] = 0;
    *names_len = nd;
    int64_t sz = out.offs.back();
    *seq_buf = (char*)std::malloc((size_t)(sz ? sz : 1));
    if (sz) std::memcpy(*seq_buf, out.seqs.p, (size_t)sz);
    *seq_offs = (int64_t*)std::calloc((size_t)k + 1, sizeof(int64_t));
    std::memcpy(*seq_offs, out.offs.data(), sizeof(int64_t) * (size_t)(k + 1));
    *n_recs = k;
    // compact: keep only the dangling (header-without-sequence) name tail
    int64_t tail = (int64_t)out.names.n - nd;
    if (tail > 0) std::memmove(out.names.p, out.names.p + nd, (size_t)tail);
    out.names.n = (size_t)tail;
    out.names_done = 0;
    out.n_names -= k;
    out.seqs.n = 0;
    out.offs.clear();
    out.offs.push_back(0);
    return 1;
}

void sctag_fastq_stream_close(void* h) {
    delete static_cast<FastqStream*>(h);
}

}  // extern "C"
