// The port's host text codec: FASTA in, TSV and VCF lines out.
//
// Plain C entry points for ctypes (pav_tpu_torch/textcodec.py), which calls
// them without the interpreter lock. Python feeds the raw (decompressed)
// bytes in and compresses what comes out (zlib, which also runs without the
// lock), so this file does text alone and needs no library.
//
// FASTA: a streaming parser fed blocks of any size. It reads a file as
// io/fasta.py's read_fasta does (universal newlines, each line stripped of
// str.isspace() characters, a header's first word its name, bases through
// seqcodec's table) and stops with a code where that reader raises, or
// where a byte lies outside ASCII (Python's text decoding decides those):
// the caller then lets that reader read the file and raise its own error.
//
// Tables: rows of typed columns formatted as pandas' to_csv(sep='\t',
// index=False) writes them (csv.QUOTE_MINIMAL, floats as Python's repr, NA
// as an empty field), or, in VCF mode, joined by tabs as they are, with each
// record's offset, chromosome and interval kept for the tabix index.

#include <algorithm>
#include <charconv>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <map>
#include <memory>
#include <string>
#include <unordered_map>
#include <unordered_set>
#include <utility>
#include <vector>

namespace {

// ------------------------------------------------------------------ FASTA

constexpr uint8_t kAmbig = 4;
// A record's codes grow in chunks of 64 KiB doubling up to 4 MiB: no copy
// as a record grows, and little room left over for short ones.
constexpr int64_t kFirstChunk = int64_t(1) << 16;
constexpr int64_t kMaxChunk = int64_t(1) << 22;

// Byte classes: 0 a base (any other byte below 0x80), 1 whitespace inside a
// line, 2 a line end, 3 outside ASCII.
struct FastaTables {
    uint8_t enc[256];
    uint8_t cls[256];
    FastaTables() {
        for (int c = 0; c < 256; ++c) {
            enc[c] = kAmbig;
            cls[c] = c >= 0x80 ? 3 : 0;
        }
        const char* bases = "ACGT";
        for (int i = 0; i < 4; ++i) {
            enc[uint8_t(bases[i])] = uint8_t(i);
            enc[uint8_t(bases[i] + 32)] = uint8_t(i);
        }
        for (int c : {9, 11, 12, 28, 29, 30, 31, 32}) cls[c] = 1;
        cls[10] = cls[13] = 2;
    }
};
const FastaTables kFa;

struct Record {
    std::string name;
    std::vector<std::unique_ptr<uint8_t[]>> chunks;
    std::vector<int64_t> sizes;
    int64_t len = 0;
};

enum FaError { kOk = 0, kBeforeHeader = 1, kDuplicate = 2, kDefer = 3 };
enum FaState { kLineStart = 0, kHeader = 1, kSequence = 2 };

struct Fasta {
    int state = kLineStart;
    int err = kOk;
    int64_t pending = 0;  // whitespace held back inside a sequence line
    std::string header;
    std::vector<Record> recs;
    std::unordered_set<std::string> names;
    uint8_t* cur = nullptr;  // free room in the last record's last chunk
    int64_t room = 0;

    void grow() {
        Record& r = recs.back();
        int64_t size = r.sizes.empty() ? kFirstChunk : std::min(2 * r.sizes.back(), kMaxChunk);
        r.chunks.emplace_back(new uint8_t[size_t(size)]);
        r.sizes.push_back(size);
        cur = r.chunks.back().get();
        room = size;
    }

    void put_ambig(int64_t n) {
        recs.back().len += n;
        while (n > 0) {
            if (room == 0) grow();
            int64_t k = std::min(n, room);
            std::memset(cur, kAmbig, size_t(k));
            cur += k;
            room -= k;
            n -= k;
        }
    }

    // Encode the bases at p up to the first byte of another class; returns
    // how many were taken.
    int64_t put_bases(const uint8_t* p, int64_t n) {
        int64_t done = 0;
        while (done < n) {
            if (room == 0) grow();
            int64_t lim = std::min(n - done, room);
            int64_t k = 0;
            while (k < lim && kFa.cls[p[done + k]] == 0) {
                cur[k] = kFa.enc[p[done + k]];
                ++k;
            }
            cur += k;
            room -= k;
            done += k;
            if (k < lim) break;
        }
        recs.back().len += done;
        return done;
    }

    bool end_header() {
        // io/fasta.py: line.strip()[1:].split()[0]
        size_t b = 0;
        while (b < header.size() && kFa.cls[uint8_t(header[b])] == 1) ++b;
        size_t e = b;
        while (e < header.size() && kFa.cls[uint8_t(header[e])] == 0) ++e;
        if (e == b) {
            err = kDefer;  // no name: the Python reader raises its own error
            return false;
        }
        std::string name = header.substr(b, e - b);
        if (!names.insert(name).second) {
            err = kDuplicate;
            return false;
        }
        recs.emplace_back();
        recs.back().name = std::move(name);
        cur = nullptr;
        room = 0;
        return true;
    }

    int feed(const uint8_t* buf, int64_t n) {
        int64_t i = 0;
        while (i < n && err == kOk) {
            if (state == kLineStart) {
                uint8_t c = buf[i];
                uint8_t k = kFa.cls[c];
                if (k == 1 || k == 2) {
                    ++i;
                } else if (k == 3) {
                    err = kDefer;
                } else if (c == '>') {
                    state = kHeader;
                    header.clear();
                    ++i;
                } else if (recs.empty()) {
                    err = kBeforeHeader;
                } else {
                    state = kSequence;
                    pending = 0;
                }
            } else if (state == kHeader) {
                int64_t j = i;
                while (j < n && kFa.cls[buf[j]] < 2) ++j;
                header.append(reinterpret_cast<const char*>(buf + i), size_t(j - i));
                i = j;
                if (j < n) {
                    if (kFa.cls[buf[j]] == 3) {
                        err = kDefer;
                    } else {
                        state = kLineStart;
                        ++i;
                        end_header();
                    }
                }
            } else {
                uint8_t k = kFa.cls[buf[i]];
                if (k == 0) {
                    if (pending) {
                        put_ambig(pending);
                        pending = 0;
                    }
                    i += put_bases(buf + i, n - i);
                } else if (k == 1) {
                    ++pending;
                    ++i;
                } else if (k == 2) {
                    pending = 0;  // trailing whitespace is stripped
                    state = kLineStart;
                    ++i;
                } else {
                    err = kDefer;
                }
            }
        }
        return err;
    }

    int finish() {
        if (err == kOk && state == kHeader) end_header();
        return err;
    }
};

// ------------------------------------------------------------------ tables

enum Kind {
    kInt64 = 0,    // int64[n]
    kFloat64 = 1,  // double[n], NaN as NA
    kBool = 2,     // uint8[n]
    kJoined = 3,   // n strings joined by '\0' (NA already empty)
    kArrow = 4,    // Arrow large_string: int64 offsets, data, validity bitmap
    kUInt64 = 5,   // uint64[n]
};

struct Column {
    int32_t kind;
    const uint8_t* data;
    const uint8_t* offsets;
    const uint8_t* valid;  // Arrow validity bitmap, or null
    int64_t bit0;          // the Arrow array's offset
    const char* next;      // kJoined: the next string
    const char* end;
};

// numpy's str of a finite double, what to_csv writes (Python's repr): the
// shortest digits that round-trip, positional for 0 and for 1e-4 <= |x| <
// 1e16, else d.ddde+XX with at least two exponent digits.
void put_double(std::string& out, double x) {
    if (std::isinf(x)) {
        out += x < 0 ? "-inf" : "inf";
        return;
    }
    char buf[64];
    auto res = std::to_chars(buf, buf + sizeof buf, x, std::chars_format::scientific);
    const char* p = buf;
    const char* stop = res.ptr;
    bool neg = false;
    if (*p == '-') {
        neg = true;
        ++p;
    }
    char digits[32];
    int nd = 0;
    while (p < stop && *p != 'e') {
        if (*p != '.') digits[nd++] = *p;
        ++p;
    }
    int exp10 = 0;
    std::from_chars(p + 1 + (p[1] == '+'), stop, exp10);
    int decpt = exp10 + 1;
    double a = std::fabs(x);
    if (neg) out += '-';
    if (a != 0 && (a < 1e-4 || a >= 1e16)) {
        out += digits[0];
        if (nd > 1) {
            out += '.';
            out.append(digits + 1, size_t(nd - 1));
        }
        out += 'e';
        out += exp10 < 0 ? '-' : '+';
        int e = exp10 < 0 ? -exp10 : exp10;
        if (e < 10) out += '0';
        char eb[8];
        auto er = std::to_chars(eb, eb + sizeof eb, e);
        out.append(eb, size_t(er.ptr - eb));
    } else if (decpt <= 0) {
        out += "0.";
        out.append(size_t(-decpt), '0');
        out.append(digits, size_t(nd));
    } else if (decpt >= nd) {
        out.append(digits, size_t(nd));
        out.append(size_t(decpt - nd), '0');
        out += ".0";
    } else {
        out.append(digits, size_t(decpt));
        out += '.';
        out.append(digits + decpt, size_t(nd - decpt));
    }
}

template <typename T>
void put_int(std::string& out, T v) {
    char buf[24];
    auto r = std::to_chars(buf, buf + sizeof buf, v);
    out.append(buf, size_t(r.ptr - buf));
}

// csv.QUOTE_MINIMAL with '"' doubled: quote a field holding the separator,
// the quote or a line end.
void put_field(std::string& out, const char* s, size_t n, bool quote) {
    if (quote) {
        bool need = false;
        for (size_t i = 0; i < n && !need; ++i) {
            char c = s[i];
            need = c == '\t' || c == '"' || c == '\n' || c == '\r';
        }
        if (need) {
            out += '"';
            for (size_t i = 0; i < n; ++i) {
                if (s[i] == '"') out += '"';
                out += s[i];
            }
            out += '"';
            return;
        }
    }
    out.append(s, n);
}

struct Table {
    std::vector<Column> cols;
    int64_t nrows = 0;
    int64_t row = 0;
    bool quote = true;  // TSV; VCF lines are written as they are
    std::string out;
    uint64_t written = 0;  // bytes handed out before `out`
    bool handed = false;   // `out` has gone out (pav_tab_next)
    // VCF mode: each record's offset in the whole file, chromosome, interval
    bool vcf = false;
    std::vector<uint64_t> ustart;
    std::vector<int32_t> chrom;
    std::vector<int64_t> beg;
    std::vector<int64_t> end;
    std::unordered_map<std::string, int32_t> chrom_ids;
    std::vector<std::string> chrom_names;
    std::string tbi;

    // Appends one field; returns the field's text start in `out` (for VCF).
    void put_cell(Column& c, int64_t r, const char** text, size_t* len) {
        size_t at = out.size();
        switch (c.kind) {
            case kInt64:
                put_int(out, reinterpret_cast<const int64_t*>(c.data)[r]);
                break;
            case kUInt64:
                put_int(out, reinterpret_cast<const uint64_t*>(c.data)[r]);
                break;
            case kFloat64: {
                double v = reinterpret_cast<const double*>(c.data)[r];
                if (!std::isnan(v)) put_double(out, v);
                break;
            }
            case kBool:
                out += c.data[r] ? "True" : "False";
                break;
            case kJoined: {
                const char* s = c.next;
                const char* z = static_cast<const char*>(std::memchr(s, 0, size_t(c.end - s)));
                if (z == nullptr) z = c.end;
                c.next = z < c.end ? z + 1 : c.end;
                put_field(out, s, size_t(z - s), quote);
                break;
            }
            case kArrow: {
                int64_t i = r + c.bit0;
                if (c.valid != nullptr && !((c.valid[i >> 3] >> (i & 7)) & 1)) break;
                int64_t a = reinterpret_cast<const int64_t*>(c.offsets)[i];
                int64_t b = reinterpret_cast<const int64_t*>(c.offsets)[i + 1];
                put_field(out, reinterpret_cast<const char*>(c.data) + a, size_t(b - a), quote);
                break;
            }
        }
        if (text != nullptr) {
            *text = out.data() + at;  // valid until `out` grows
            *len = out.size() - at;
        }
    }

    void put_row(int64_t r) {
        size_t line = out.size();
        int64_t pos = 0;
        int64_t ref_chars = 0;
        for (size_t j = 0; j < cols.size(); ++j) {
            if (j) out += '\t';
            if (!vcf) {
                put_cell(cols[j], r, nullptr, nullptr);
                continue;
            }
            const char* t;
            size_t n;
            put_cell(cols[j], r, &t, &n);
            if (j == 0) {
                std::string name(t, n);
                auto it = chrom_ids.find(name);
                if (it == chrom_ids.end()) {
                    it = chrom_ids.emplace(name, int32_t(chrom_names.size())).first;
                    chrom_names.push_back(name);
                }
                chrom.push_back(it->second);
            } else if (j == 1) {
                std::from_chars(t, t + n, pos);
            } else if (j == 3) {
                for (size_t i = 0; i < n; ++i) ref_chars += (uint8_t(t[i]) & 0xC0) != 0x80;
            }
        }
        // The only field of a row, when empty, is written as "" (csv.writer).
        if (quote && cols.size() == 1 && out.size() == line) out += "\"\"";
        out += '\n';
        if (vcf) {
            ustart.push_back(written + line);
            beg.push_back(pos - 1);
            end.push_back(pos - 1 + std::max<int64_t>(ref_chars, 1));
        }
    }

    // The next text: rows formatted until `target` bytes or the last row.
    void next(int64_t target) {
        if (handed) {
            written += out.size();
            out.clear();
        }
        handed = true;
        while (row < nrows && int64_t(out.size()) < target) put_row(row++);
    }

    static uint32_t reg2bin(int64_t b, int64_t e) {
        --e;
        if (b >> 14 == e >> 14) return uint32_t(((1 << 15) - 1) / 7 + (b >> 14));
        if (b >> 17 == e >> 17) return uint32_t(((1 << 12) - 1) / 7 + (b >> 17));
        if (b >> 20 == e >> 20) return uint32_t(((1 << 9) - 1) / 7 + (b >> 20));
        if (b >> 23 == e >> 23) return uint32_t(((1 << 6) - 1) / 7 + (b >> 23));
        if (b >> 26 == e >> 26) return uint32_t(((1 << 3) - 1) / 7 + (b >> 26));
        return 0;
    }

    template <typename T>
    void put_le(T v) {
        char b[sizeof(T)];
        std::memcpy(b, &v, sizeof(T));  // little-endian hosts only
        tbi.append(b, sizeof(T));
    }

    // The tabix index (io/tabix.py's write_tabix), uncompressed; cstart[k]
    // is the compressed start of BGZF block k of `block` bytes (the entry
    // past the last block the file's compressed length). Returns false where
    // a record starts before position 0, which the Python writer handles.
    bool build_tbi(const int64_t* cstart, int64_t block, uint64_t total) {
        size_t n = ustart.size();
        for (size_t i = 0; i < n; ++i)
            if (beg[i] < 0) return false;
        auto voff = [&](uint64_t u) {
            return (uint64_t(cstart[u / uint64_t(block)]) << 16) | (u % uint64_t(block));
        };
        std::vector<std::vector<size_t>> by_ref(chrom_names.size());
        for (size_t i = 0; i < n; ++i) by_ref[size_t(chrom[i])].push_back(i);
        tbi.clear();
        tbi += "TBI\x01";
        put_le<int32_t>(int32_t(chrom_names.size()));
        for (int32_t v : {2, 1, 2, 0, int32_t('#'), 0}) put_le<int32_t>(v);
        int32_t l_nm = 0;
        for (auto& s : chrom_names) l_nm += int32_t(s.size() + 1);
        put_le<int32_t>(l_nm);
        for (auto& s : chrom_names) {
            tbi += s;
            tbi += '\0';
        }
        for (auto& recs : by_ref) {
            std::map<uint32_t, std::vector<std::pair<uint64_t, uint64_t>>> bins;
            int64_t n_wins = 0;
            for (size_t i : recs) {
                int64_t e = std::max(end[i], beg[i] + 1);
                uint64_t vs = voff(ustart[i]);
                uint64_t ve = voff(i + 1 < n ? ustart[i + 1] : total);
                bins[reg2bin(beg[i], e)].emplace_back(vs, ve);
                n_wins = std::max(n_wins, (e - 1) >> 14);
            }
            n_wins += 1;
            std::vector<uint64_t> ioff(size_t(n_wins), 0);
            std::vector<char> seen(size_t(n_wins), 0);
            for (size_t i : recs) {
                int64_t e = std::max(end[i], beg[i] + 1);
                uint64_t vs = voff(ustart[i]);
                for (int64_t w = beg[i] >> 14; w <= (e - 1) >> 14; ++w) {
                    if (!seen[size_t(w)] || vs < ioff[size_t(w)]) {
                        ioff[size_t(w)] = vs;
                        seen[size_t(w)] = 1;
                    }
                }
            }
            uint64_t last = 0;
            for (int64_t w = 0; w < n_wins; ++w) {
                if (seen[size_t(w)]) last = ioff[size_t(w)];
                else ioff[size_t(w)] = last;
            }
            put_le<int32_t>(int32_t(bins.size()));
            for (auto& kv : bins) {
                auto& ch = kv.second;
                std::sort(ch.begin(), ch.end());
                std::vector<std::pair<uint64_t, uint64_t>> merged{ch[0]};
                for (size_t k = 1; k < ch.size(); ++k) {
                    if (ch[k].first <= merged.back().second) {
                        merged.back().second = std::max(merged.back().second, ch[k].second);
                    } else {
                        merged.push_back(ch[k]);
                    }
                }
                put_le<uint32_t>(kv.first);
                put_le<int32_t>(int32_t(merged.size()));
                for (auto& c : merged) {
                    put_le<uint64_t>(c.first);
                    put_le<uint64_t>(c.second);
                }
            }
            put_le<int32_t>(int32_t(n_wins));
            for (uint64_t v : ioff) put_le<uint64_t>(v);
        }
        return true;
    }
};

}  // namespace

extern "C" {

// ---- FASTA

void* pav_fa_new() { return new Fasta(); }

void pav_fa_free(void* h) { delete static_cast<Fasta*>(h); }

// Parse the next `n` bytes; returns the error code (0: go on).
int pav_fa_feed(void* h, const uint8_t* buf, int64_t n) {
    return static_cast<Fasta*>(h)->feed(buf, n);
}

// The input ended; returns the error code.
int pav_fa_finish(void* h) { return static_cast<Fasta*>(h)->finish(); }

int64_t pav_fa_count(void* h) { return int64_t(static_cast<Fasta*>(h)->recs.size()); }

// Record i's name (and its length in bytes through *len) and its base count.
const char* pav_fa_name(void* h, int64_t i, int64_t* len) {
    const std::string& s = static_cast<Fasta*>(h)->recs[size_t(i)].name;
    *len = int64_t(s.size());
    return s.data();
}

int64_t pav_fa_len(void* h, int64_t i) { return static_cast<Fasta*>(h)->recs[size_t(i)].len; }

// Copy record i's codes to `out` (pav_fa_len bytes) and free them.
void pav_fa_take(void* h, int64_t i, uint8_t* out) {
    Record& r = static_cast<Fasta*>(h)->recs[size_t(i)];
    int64_t left = r.len;
    for (size_t k = 0; k < r.chunks.size(); ++k) {
        int64_t n = std::min(left, r.sizes[k]);
        std::memcpy(out, r.chunks[k].get(), size_t(n));
        out += n;
        left -= n;
    }
    std::vector<std::unique_ptr<uint8_t[]>>().swap(r.chunks);
    std::vector<int64_t>().swap(r.sizes);
}

// ---- tables

// A table of `ncols` columns of `nrows` rows (the arrays stay owned by the
// caller, who keeps them alive until pav_tab_free). vcf != 0: no quoting,
// and each record's offset (from `base`), chromosome (column 0), position
// (column 1) and REF (column 3) are kept for pav_tab_tabix.
void* pav_tab_new(int32_t ncols, int64_t nrows, const int32_t* kinds, void* const* data,
                  void* const* offsets, void* const* valid, const int64_t* bit0,
                  const int64_t* data_len, int32_t vcf, int64_t base) {
    auto* t = new Table();
    t->nrows = nrows;
    t->vcf = vcf != 0;
    t->quote = vcf == 0;
    t->written = uint64_t(base);
    for (int32_t j = 0; j < ncols; ++j) {
        Column c{};
        c.kind = kinds[j];
        c.data = static_cast<const uint8_t*>(data[j]);
        c.offsets = static_cast<const uint8_t*>(offsets[j]);
        c.valid = static_cast<const uint8_t*>(valid[j]);
        c.bit0 = bit0[j];
        c.next = reinterpret_cast<const char*>(c.data);
        c.end = c.next + data_len[j];
        t->cols.push_back(c);
    }
    if (t->vcf) {
        t->ustart.reserve(size_t(nrows));
        t->chrom.reserve(size_t(nrows));
        t->beg.reserve(size_t(nrows));
        t->end.reserve(size_t(nrows));
    }
    return t;
}

void pav_tab_free(void* h) { delete static_cast<Table*>(h); }

// Format a header row of `ncols` names joined by '\0' (TSV only), to be
// handed out by the next pav_tab_next.
void pav_tab_header(void* h, const char* names, int64_t len, int32_t ncols) {
    auto* t = static_cast<Table*>(h);
    Column c{};
    c.kind = kJoined;
    c.next = names;
    c.end = names + len;
    size_t line = t->out.size();
    for (int32_t j = 0; j < ncols; ++j) {
        if (j) t->out += '\t';
        t->put_cell(c, 0, nullptr, nullptr);
    }
    if (ncols == 1 && t->out.size() == line) t->out += "\"\"";
    t->out += '\n';
}

// Format rows until at least `target` bytes are pending or the rows run
// out (a header formatted before goes out with the first rows); *text and
// *len give the bytes, valid until the next call. Returns the number of rows
// formatted so far.
int64_t pav_tab_next(void* h, int64_t target, const char** text, int64_t* len) {
    auto* t = static_cast<Table*>(h);
    t->next(target);
    *text = t->out.data();
    *len = int64_t(t->out.size());
    return t->row;
}

// The uncompressed tabix index of the VCF records (see Table::build_tbi);
// 0 where the Python writer has to make it.
int32_t pav_tab_tabix(void* h, const int64_t* cstart, int64_t block, int64_t total,
                      const char** text, int64_t* len) {
    auto* t = static_cast<Table*>(h);
    if (!t->build_tbi(cstart, block, uint64_t(total))) return 0;
    *text = t->tbi.data();
    *len = int64_t(t->tbi.size());
    return 1;
}

}  // extern "C"
