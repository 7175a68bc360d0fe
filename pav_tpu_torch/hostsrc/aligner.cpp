// The aligner's host path over columns: a contig's chain selection and
// plans, and a haplotype's alignment records.
//
// Plain C entry points for ctypes (pav_tpu_torch/align/aligner/hostplan.py),
// which calls them without the interpreter lock. The decisions are those of
// align/aligner/core.py's Python planner, step for step and in the same
// order, so both give the same segments, parts and records:
//
// - pav_plan_contig: both selection passes (_select, _covered_spans, the
//   best secondary score and _mapq), each accepted chain's boundary walk
//   (_plan_chain, _add_segment, _refine_segment's unique 21-mer anchors and
//   their longest increasing run, to the depth core.py sets) and the contig's end
//   extensions (_plan_end_extensions). It returns columns: one row a chain,
//   its parts (a run of one op, or a segment) and its segments (a kind and
//   the query and reference windows the DP gathers).
// - pav_emit_records: the post-DP break test, each chain's records split at
//   breaks (_chain_records: _trim_ext_runs, merge_adjacent, leading and
//   trailing I/D stripped, _MIN_RECORD_ALIGNED, the H clips) and their
//   CIGAR strings.
//
// Op codes are SAM's (align/cigar.py): I 1, D 2, H 5, = 7, X 8. A part's op
// of -1 marks a segment, its length then the segment's number.

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstring>
#include <string>
#include <utility>
#include <vector>

namespace {

constexpr int8_t kI = 1, kD = 2, kEq = 7, kX = 8, kSeg = -1;
constexpr int8_t kDp = 0, kBreak = 1, kExtL = 2, kExtR = 3;

inline bool consumes_q(int8_t op) { return op == 0 || op == kI || op == 4 || op == kEq || op == kX; }
inline bool consumes_r(int8_t op) { return op == 0 || op == kD || op == 3 || op == kEq || op == kX; }

// The thresholds of core.py, handed over by the caller (core._native_params).
struct Params {
    double direct_mismatch_frac;
    int64_t break_min_len;
    double break_mismatch_frac;
    double break_min_identity;
    int64_t min_record_aligned;
    int64_t max_extend;
    int64_t refine_k;
    double max_overlap_frac;
    int64_t refine_min_len;
    int64_t refine_max_depth;
    double refine_min_span;
};

Params read_params(const double* p) {
    return Params{p[0], int64_t(p[1]), p[2], p[3], int64_t(p[4]), int64_t(p[5]),
                  int64_t(p[6]), p[7], int64_t(p[8]), int64_t(p[9]), p[10]};
}

// ------------------------------------------------------------------ plans

// One window of a segment: query windows lie on the contig in the chain's
// orientation (src 0 forward, 1 reverse complement), reference windows on a
// chromosome (src its number); rev reads the window backwards.
struct Segment {
    int64_t kind, qsrc, qoff, qlen, qrev, rsrc, roff, rlen, rrev;
};

struct Part {
    int64_t len;   // run length, or segment number
    int8_t op;     // SAM op, or kSeg
};

struct Meta {
    int64_t chain, q_start, r_start, q_end, r_end, mapq;
    std::vector<Part> parts;
};

struct Contig {
    const uint8_t* seq[2];
    int64_t qlen;
    const uint8_t* const* ref;
    const int64_t* ref_len;
    const int64_t* off;
    const int64_t* qpos;
    const int64_t* rpos;
    const int32_t* chrom;
    const uint8_t* rev;
    const double* score;
    int64_t k;
    Params p;
};

struct Plan {
    std::vector<Meta> metas;
    std::vector<Segment> segs;
    // Flattened by pav_plan_contig for the take calls.
    std::vector<int64_t> chain_rows, part_len, seg_rows;
    std::vector<int8_t> part_op;
};

using Span = std::pair<int64_t, int64_t>;

std::vector<Span> coalesce(std::vector<Span> spans) {
    std::vector<Span> out;
    if (spans.empty()) return out;
    std::sort(spans.begin(), spans.end());
    out.push_back(spans[0]);
    for (size_t i = 1; i < spans.size(); ++i) {
        if (spans[i].first <= out.back().second)
            out.back().second = std::max(out.back().second, spans[i].second);
        else
            out.push_back(spans[i]);
    }
    return out;
}

class Planner {
public:
    Planner(const Contig& c, Plan& plan) : c_(c), plan_(plan) {}

    void run(int64_t n_chains) {
        std::vector<int64_t> all(n_chains);
        for (int64_t i = 0; i < n_chains; ++i) all[i] = i;
        best_sec_.assign(n_chains, 0.0);

        // Pass 1: primary selection by original-frame query-span overlap.
        std::vector<int64_t> accepted = select(all, {});
        std::vector<char> taken(n_chains, 0);
        for (int64_t ci : accepted) {
            taken[ci] = 1;
            plan_chain(ci);
        }
        // Coverage without break segments; pass 2 fills the gaps.
        std::vector<Span> covered;
        for (const Meta& m : plan_.metas) {
            std::vector<Span> mine = covered_spans(m);
            covered.insert(covered.end(), mine.begin(), mine.end());
        }
        std::vector<int64_t> remaining;
        for (int64_t i = 0; i < n_chains; ++i)
            if (!taken[i]) remaining.push_back(i);
        for (int64_t ci : select(remaining, covered)) plan_chain(ci);
        plan_end_extensions();
    }

private:
    const Contig& c_;
    Plan& plan_;
    std::vector<double> best_sec_;

    Span orig_span(int64_t ci) const {
        int64_t lo = c_.qpos[c_.off[ci]];
        int64_t hi = c_.qpos[c_.off[ci + 1] - 1] + c_.k;
        if (c_.rev[ci]) return {c_.qlen - hi, c_.qlen - lo};
        return {lo, hi};
    }

    // _select: greedy best-score-first; a rejected chain's score is the
    // best secondary of every accepted chain it overlaps.
    std::vector<int64_t> select(const std::vector<int64_t>& chains,
                                const std::vector<Span>& covered) {
        std::vector<Span> spans = coalesce(covered);
        const size_t n_base = spans.size();
        std::vector<int64_t> order(chains);
        std::stable_sort(order.begin(), order.end(), [&](int64_t a, int64_t b) {
            return c_.score[a] > c_.score[b];
        });
        std::vector<int64_t> accepted;
        std::vector<double> best;
        for (int64_t ci : order) {
            Span s = orig_span(ci);
            const int64_t lo = s.first, hi = s.second, length = hi - lo;
            if (length <= 0) continue;
            int64_t overlap = 0;
            for (const Span& t : spans)
                overlap += std::max<int64_t>(0, std::min(t.second, hi) - std::max(t.first, lo));
            if (double(overlap) <= c_.p.max_overlap_frac * double(length)) {
                accepted.push_back(ci);
                best.push_back(0.0);
                spans.push_back(s);
            } else if (!accepted.empty()) {
                for (size_t j = n_base; j < spans.size(); ++j) {
                    if (std::min(spans[j].second, hi) - std::max(spans[j].first, lo) > 0)
                        best[j - n_base] = std::max(best[j - n_base], c_.score[ci]);
                }
            }
        }
        for (size_t j = 0; j < accepted.size(); ++j) best_sec_[accepted[j]] = best[j];
        return accepted;
    }

    int64_t mapq(int64_t ci) const {
        const double score = c_.score[ci];
        if (score <= 0) return 0;
        const double ratio = 1.0 - std::min(best_sec_[ci] / score, 1.0);
        // Python's round(): to the nearest, ties to even (the default mode).
        return std::min<int64_t>(60, int64_t(std::nearbyint(60 * ratio)));
    }

    std::vector<Span> covered_spans(const Meta& m) const {
        std::vector<Span> out;
        int64_t q_cur = m.q_start;
        const bool rev = c_.rev[m.chain];
        auto add = [&](int64_t lo, int64_t hi) {
            if (hi <= lo) return;
            if (rev) out.emplace_back(c_.qlen - hi, c_.qlen - lo);
            else out.emplace_back(lo, hi);
        };
        for (const Part& part : m.parts) {
            if (part.op != kSeg) {
                const int64_t adv = consumes_q(part.op) ? part.len : 0;
                add(q_cur, q_cur + adv);
                q_cur += adv;
            } else {
                const Segment& s = plan_.segs[part.len];
                if (s.kind != kBreak) add(q_cur, q_cur + s.qlen);
                q_cur += s.qlen;
            }
        }
        return coalesce(out);
    }

    void run_part(std::vector<Part>& parts, int64_t len, int8_t op) {
        parts.push_back(Part{len, op});
    }

    void add_seg(std::vector<Part>& parts, Segment s) {
        parts.push_back(Part{int64_t(plan_.segs.size()), kSeg});
        plan_.segs.push_back(s);
    }

    // _plan_chain: exact runs between boundaries, a segment at each.
    void plan_chain(int64_t ci) {
        const int64_t k = c_.k;
        const int64_t a0 = c_.off[ci], a1 = c_.off[ci + 1];
        const int64_t* qp = c_.qpos + a0;
        const int64_t* rp = c_.rpos + a0;
        const int64_t n = a1 - a0;
        const int qsrc = c_.rev[ci] ? 1 : 0;
        const int32_t chrom = c_.chrom[ci];
        Meta m;
        m.chain = ci;
        std::vector<Part>& parts = m.parts;
        if (n == 1) {
            run_part(parts, k, kEq);
        } else {
            int64_t seg_start = 0;
            for (int64_t a = 0; a + 1 < n; ++a) {
                const int64_t dq = qp[a + 1] - qp[a], dr = rp[a + 1] - rp[a];
                if (dq == dr && dq <= k) continue;
                const int64_t cut = std::max<int64_t>(0, std::max(k - dq, k - dr));
                const int64_t sq0 = qp[a] + k - cut, sr0 = rp[a] + k - cut;
                const int64_t run_len = k + (qp[a] - qp[seg_start]) - cut;
                if (run_len > 0) run_part(parts, run_len, kEq);
                add_segment(parts, qsrc, sq0, qp[a + 1] - sq0, chrom, sr0, rp[a + 1] - sr0, 0);
                seg_start = a + 1;
            }
            run_part(parts, k + (qp[n - 1] - qp[seg_start]), kEq);
        }
        m.q_start = qp[0];
        m.r_start = rp[0];
        m.q_end = qp[n - 1] + k;
        m.r_end = rp[n - 1] + k;
        m.mapq = mapq(ci);
        plan_.metas.push_back(std::move(m));
    }

    // _add_segment: pure gaps and near-exact equal-length windows inline,
    // random equal-length windows as breaks, large ones refined, the rest DP.
    void add_segment(std::vector<Part>& parts, int qsrc, int64_t qo, int64_t lq,
                     int32_t chrom, int64_t ro, int64_t lr, int depth) {
        if (lq == 0 && lr == 0) return;
        if (lq == 0) { run_part(parts, lr, kD); return; }
        if (lr == 0) { run_part(parts, lq, kI); return; }
        const uint8_t* q = c_.seq[qsrc] + qo;
        const uint8_t* r = c_.ref[chrom] + ro;
        if (lq == lr) {
            int64_t n_mism = 0;
            for (int64_t i = 0; i < lq; ++i) n_mism += (q[i] != r[i]) | (q[i] >= 4);
            if (double(n_mism) <= std::max(2.0, c_.p.direct_mismatch_frac * double(lq))) {
                // _runs_from_positions: =/X runs of this window alone.
                int64_t prev = 0;
                bool in_x = false;
                for (int64_t i = 0; i < lq; ++i) {
                    if (q[i] == r[i] && q[i] < 4) continue;
                    if (i > prev) {
                        run_part(parts, i - prev, kEq);
                        in_x = false;
                    }
                    if (in_x) parts.back().len += 1;
                    else run_part(parts, 1, kX);
                    in_x = true;
                    prev = i + 1;
                }
                if (lq > prev) run_part(parts, lq - prev, kEq);
                return;
            }
            if (lq >= c_.p.break_min_len && double(n_mism) >= c_.p.break_mismatch_frac * double(lq)) {
                add_seg(parts, Segment{kBreak, qsrc, qo, lq, 0, chrom, ro, lr, 0});
                return;
            }
        }
        if (depth < c_.p.refine_max_depth && std::min(lq, lr) >= c_.p.refine_min_len) {
            if (refine(parts, qsrc, qo, lq, chrom, ro, lr, depth)) return;
        }
        add_seg(parts, Segment{kDp, qsrc, qo, lq, 0, chrom, ro, lr, 0});
    }

    // (value, position) of each k-mer of s[0:n] seen exactly once among its
    // windows free of ambiguous bases, by value.
    std::vector<std::pair<uint64_t, int64_t>> unique_kmers(const uint8_t* s, int64_t n) const {
        const int64_t k = c_.p.refine_k;
        std::vector<std::pair<uint64_t, int64_t>> all;
        if (n < k) return all;
        const uint64_t mask = k >= 32 ? ~uint64_t(0) : ((uint64_t(1) << (2 * k)) - 1);
        uint64_t v = 0;
        int64_t run = 0;   // valid bases ending here
        all.reserve(size_t(n - k + 1));
        for (int64_t i = 0; i < n; ++i) {
            const uint8_t b = s[i];
            v = ((v << 2) | (b > 3 ? 0 : b)) & mask;
            run = b > 3 ? 0 : run + 1;
            if (i >= k - 1 && run >= k) all.emplace_back(v, i - k + 1);
        }
        std::sort(all.begin(), all.end());
        std::vector<std::pair<uint64_t, int64_t>> out;
        for (size_t i = 0; i < all.size();) {
            size_t j = i + 1;
            while (j < all.size() && all[j].first == all[i].first) ++j;
            if (j == i + 1) out.push_back(all[i]);
            i = j;
        }
        return out;
    }

    // _lis_indices: a longest strictly increasing subsequence, the one the
    // Python's bisect_left over tails picks.
    static std::vector<int64_t> lis(const std::vector<int64_t>& arr) {
        const int64_t n = int64_t(arr.size());
        std::vector<int64_t> tails, tails_idx, parent(n, -1);
        for (int64_t i = 0; i < n; ++i) {
            const int64_t v = arr[i];
            const int64_t j = std::lower_bound(tails.begin(), tails.end(), v) - tails.begin();
            if (j == int64_t(tails.size())) {
                tails.push_back(v);
                tails_idx.push_back(i);
            } else {
                tails[j] = v;
                tails_idx[j] = i;
            }
            if (j > 0) parent[i] = tails_idx[j - 1];
        }
        std::vector<int64_t> out;
        if (n == 0) return out;
        for (int64_t i = tails_idx.back(); i >= 0; i = parent[i]) out.push_back(i);
        std::reverse(out.begin(), out.end());
        return out;
    }

    // _refine_segment: split along collinear unique k-mers; false leaves
    // the window one DP segment.
    bool refine(std::vector<Part>& parts, int qsrc, int64_t qo, int64_t lq,
                int32_t chrom, int64_t ro, int64_t lr, int depth) {
        const int64_t k2 = c_.p.refine_k;
        auto qu = unique_kmers(c_.seq[qsrc] + qo, lq);
        auto ru = unique_kmers(c_.ref[chrom] + ro, lr);
        std::vector<std::pair<int64_t, int64_t>> common;   // (aq, ar)
        for (size_t i = 0, j = 0; i < qu.size() && j < ru.size();) {
            if (qu[i].first < ru[j].first) ++i;
            else if (ru[j].first < qu[i].first) ++j;
            else common.emplace_back(qu[i++].second, ru[j++].second);
        }
        if (common.size() < 3) return false;
        std::sort(common.begin(), common.end());
        std::vector<int64_t> ar_all(common.size());
        for (size_t i = 0; i < common.size(); ++i) ar_all[i] = common[i].second;
        const std::vector<int64_t> idx = lis(ar_all);
        if (idx.size() < 3) return false;
        std::vector<int64_t> aq(idx.size()), ar(idx.size());
        for (size_t i = 0; i < idx.size(); ++i) {
            aq[i] = common[idx[i]].first;
            ar[i] = common[idx[i]].second;
        }
        if (double(aq.back() - aq[0]) < c_.p.refine_min_span * double(lq)
            && double(ar.back() - ar[0]) < c_.p.refine_min_span * double(lr))
            return false;

        int64_t run_len = 0;
        for (size_t i = 0; i < aq.size(); ++i) {
            const int64_t q0 = aq[i], r0 = ar[i];
            if (i == 0) {
                add_segment(parts, qsrc, qo, q0, chrom, ro, r0, depth + 1);
                run_len = k2;
                continue;
            }
            const int64_t dq = q0 - aq[i - 1], dr = r0 - ar[i - 1];
            if (dq == dr && dq <= k2) {
                run_len += dq;
                continue;
            }
            const int64_t cut = std::max<int64_t>(0, std::max(k2 - dq, k2 - dr));
            const int64_t eff = run_len - cut;
            if (eff > 0) run_part(parts, eff, kEq);
            const int64_t sq0 = aq[i - 1] + k2 - cut, sr0 = ar[i - 1] + k2 - cut;
            add_segment(parts, qsrc, qo + sq0, q0 - sq0, chrom, ro + sr0, r0 - sr0, depth + 1);
            run_len = k2;
        }
        if (run_len > 0) run_part(parts, run_len, kEq);
        const int64_t tq = aq.back() + k2, tr = ar.back() + k2;
        add_segment(parts, qsrc, qo + tq, lq - tq, chrom, ro + tr, lr - tr, depth + 1);
        return true;
    }

    // _plan_end_extensions / _plan_one_extension.
    void plan_end_extensions() {
        const int64_t qlen = c_.qlen;
        int64_t lo_min = qlen, hi_max = 0;
        int64_t lo_meta = -1, hi_meta = -1;
        for (size_t i = 0; i < plan_.metas.size(); ++i) {
            const Meta& m = plan_.metas[i];
            int64_t lo = m.q_start, hi = m.q_end;
            if (c_.rev[m.chain]) {
                lo = qlen - m.q_end;
                hi = qlen - m.q_start;
            }
            if (hi <= lo) continue;
            if (lo < lo_min) { lo_min = lo; lo_meta = int64_t(i); }
            if (hi > hi_max) { hi_max = hi; hi_meta = int64_t(i); }
        }
        if (lo_meta >= 0 && 0 < lo_min)
            extend(plan_.metas[lo_meta], true, std::min(lo_min, c_.p.max_extend));
        if (hi_meta >= 0 && hi_max < qlen)
            extend(plan_.metas[hi_meta], false, std::min(qlen - hi_max, c_.p.max_extend));
    }

    void extend(Meta& m, bool orig_start, int64_t e) {
        if (e <= 0) return;
        const bool is_rev = c_.rev[m.chain];
        const int qsrc = is_rev ? 1 : 0;
        const int32_t chrom = c_.chrom[m.chain];
        const bool left = orig_start != is_rev;
        const int64_t slack = std::min<int64_t>(e / 8 + 32, 512);
        if (left) {
            e = std::min(e, m.q_start);
            const int64_t w0 = std::min(e + slack, m.r_start);
            if (e <= 0 || w0 <= 0) return;
            Segment s{kExtL, qsrc, m.q_start - e, e, 1, chrom, m.r_start - w0, w0, 1};
            m.q_start -= e;
            m.r_start -= w0;
            m.parts.insert(m.parts.begin(), Part{int64_t(plan_.segs.size()), kSeg});
            plan_.segs.push_back(s);
        } else {
            e = std::min(e, c_.qlen - m.q_end);
            const int64_t w0 = std::min(e + slack, c_.ref_len[chrom] - m.r_end);
            if (e <= 0 || w0 <= 0) return;
            add_seg(m.parts, Segment{kExtR, qsrc, m.q_end, e, 0, chrom, m.r_end, w0, 0});
        }
    }
};

// ---------------------------------------------------------------- records

struct Records {
    std::vector<int64_t> rows;   // chain, r0, r1, qry_pos, qry_end a record
    std::string cigars;          // one a record, each ended by '\n'
};

struct Scoring {
    int64_t match, mismatch, o1, o2, e1, e2;
};

struct Run {
    int64_t len;
    int8_t op;
};

const char kOpChars[] = "MIDNSHP=X";

// _trim_ext_runs: the extension's best-scoring prefix, the rest as I/D at
// the outer side.
void trim_ext(std::vector<Run>& out, const int32_t* lens, const int8_t* ops, int64_t n,
              const Scoring& sc, bool reversed, int64_t lq, int64_t lr) {
    int64_t cum = 0, best = 0, cut = 0;
    bool any = false;
    for (int64_t i = 0; i < n; ++i) {
        const int64_t l = lens[i];
        int64_t s;
        if (ops[i] == kEq) s = sc.match * l;
        else if (ops[i] == kX) s = sc.mismatch * l;
        else s = -std::min(sc.o1 + sc.e1 * l, sc.o2 + sc.e2 * l);
        cum += s;
        if (!any || cum > best) { best = cum; cut = i + 1; any = true; }
    }
    if (!any || best <= 0) cut = 0;
    int64_t kept_q = 0, kept_r = 0;
    for (int64_t i = 0; i < cut; ++i) {
        if (consumes_q(ops[i])) kept_q += lens[i];
        if (consumes_r(ops[i])) kept_r += lens[i];
    }
    std::vector<Run> rem;
    if (lq - kept_q > 0) rem.push_back(Run{lq - kept_q, kI});
    if (lr - kept_r > 0) rem.push_back(Run{lr - kept_r, kD});
    if (reversed) {
        out.insert(out.end(), rem.begin(), rem.end());
        for (int64_t i = cut - 1; i >= 0; --i) out.push_back(Run{lens[i], ops[i]});
    } else {
        for (int64_t i = 0; i < cut; ++i) out.push_back(Run{lens[i], ops[i]});
        out.insert(out.end(), rem.begin(), rem.end());
    }
}

}  // namespace

extern "C" {

// Plan one contig. fwd and rc are the contig's codes in both orientations
// (rc may be null when no chain is reverse), ref/ref_len the chromosomes by
// number. Chain i's anchors are qpos/rpos[off[i]:off[i+1]] (reverse chains'
// qpos in the reverse-complement frame), its chromosome, strand and score
// beside them. params: core._native_params(). Returns a plan for the take calls.
void* pav_plan_contig(const uint8_t* fwd, const uint8_t* rc, int64_t qlen,
                      const int64_t* ref_ptrs, const int64_t* ref_len,
                      int64_t n_chains, const int64_t* off, const int64_t* qpos,
                      const int64_t* rpos, const int32_t* chrom, const uint8_t* rev,
                      const double* score, int64_t k, const double* params) {
    Plan* plan = new Plan();
    Contig c{{fwd, rc}, qlen, reinterpret_cast<const uint8_t* const*>(ref_ptrs), ref_len,
             off, qpos, rpos, chrom, rev, score, k, read_params(params)};
    Planner(c, *plan).run(n_chains);
    for (const Meta& m : plan->metas) {
        const int64_t row[9] = {chrom[m.chain], rev[m.chain], m.q_start, m.r_start, m.q_end,
                                m.r_end, m.mapq, int64_t(plan->part_len.size()),
                                int64_t(m.parts.size())};
        plan->chain_rows.insert(plan->chain_rows.end(), row, row + 9);
        for (const Part& p : m.parts) {
            plan->part_len.push_back(p.len);
            plan->part_op.push_back(p.op);
        }
    }
    for (const Segment& s : plan->segs) {
        const int64_t row[9] = {s.kind, s.qsrc, s.qoff, s.qlen, s.qrev,
                                s.rsrc, s.roff, s.rlen, s.rrev};
        plan->seg_rows.insert(plan->seg_rows.end(), row, row + 9);
    }
    return plan;
}

// Rows of a plan's column: 0 chains (9 int64 a row: chrom, rev,
// q_start, r_start, q_end, r_end, mapq, first part, parts), 1 parts, 2
// segments (9 int64 a row: kind, qsrc, qoff, qlen, qrev, rsrc, roff, rlen,
// rrev).
int64_t pav_plan_count(void* h, int32_t which) {
    Plan* p = static_cast<Plan*>(h);
    if (which == 0) return int64_t(p->metas.size());
    if (which == 1) return int64_t(p->part_len.size());
    return int64_t(p->segs.size());
}

// Copy a column out: 0 chain rows, 1 part lengths (int64), 2 part ops
// (int8), 3 segment rows.
void pav_plan_take(void* h, int32_t which, void* out) {
    Plan* p = static_cast<Plan*>(h);
    const void* src;
    size_t bytes;
    if (which == 0) { src = p->chain_rows.data(); bytes = p->chain_rows.size() * 8; }
    else if (which == 1) { src = p->part_len.data(); bytes = p->part_len.size() * 8; }
    else if (which == 2) { src = p->part_op.data(); bytes = p->part_op.size(); }
    else { src = p->seg_rows.data(); bytes = p->seg_rows.size() * 8; }
    if (bytes) std::memcpy(out, src, bytes);
}

void pav_plan_free(void* h) { delete static_cast<Plan*>(h); }

// A haplotype's records. Chain i (q_start, r_start, qlen, is_rev, first
// part, parts: 6 int64 a row of chains) walks its parts (part_len,
// part_op); segment s (kind, qlen, rlen, first result run, runs: 5 int64
// a row of segs) has its DP result in res_lens/res_ops. scoring: match,
// mismatch, gap opens, gap extends. Returns the records for the take calls.
void* pav_emit_records(int64_t n_chains, const int64_t* chains, const int64_t* part_len,
                       const int8_t* part_op, const int64_t* segs, const int32_t* res_lens,
                       const int8_t* res_ops, const int64_t* scoring, const double* params) {
    const Params p = read_params(params);
    const Scoring sc{scoring[0], scoring[1], scoring[2], scoring[3], scoring[4], scoring[5]};
    Records* out = new Records();
    std::vector<Run> runs, merged;
    for (int64_t ci = 0; ci < n_chains; ++ci) {
        const int64_t* ch = chains + 6 * ci;
        const int64_t qlen = ch[2];
        const bool is_rev = ch[3] != 0;
        int64_t q_cur = ch[0], r_cur = ch[1];
        int64_t rec_q0 = q_cur, rec_r0 = r_cur;
        runs.clear();

        auto close = [&](int64_t q_end, int64_t r_end) {
            if (runs.empty()) return;
            merged.clear();
            for (const Run& r : runs) {
                if (r.len <= 0) continue;
                if (!merged.empty() && merged.back().op == r.op) merged.back().len += r.len;
                else merged.push_back(r);
            }
            int64_t aligned_q = 0;
            for (const Run& r : merged)
                if (consumes_q(r.op)) aligned_q += int64_t(int32_t(r.len));
            if (aligned_q < p.min_record_aligned) return;
            size_t i0 = 0, i1 = merged.size();
            int64_t lead_q = 0, lead_r = 0, tail_q = 0, tail_r = 0;
            while (i0 < i1 && (merged[i0].op == kI || merged[i0].op == kD)) {
                (merged[i0].op == kI ? lead_q : lead_r) += int32_t(merged[i0].len);
                ++i0;
            }
            while (i1 > i0 && (merged[i1 - 1].op == kI || merged[i1 - 1].op == kD)) {
                (merged[i1 - 1].op == kI ? tail_q : tail_r) += int32_t(merged[i1 - 1].len);
                --i1;
            }
            if (i1 == i0) return;
            const int64_t q0 = rec_q0 + lead_q, r0 = rec_r0 + lead_r;
            const int64_t q1 = q_end - tail_q, r1 = r_end - tail_r;
            std::string& s = out->cigars;
            if (q0 > 0) s += std::to_string(q0) + 'H';
            for (size_t i = i0; i < i1; ++i) {
                s += std::to_string(int32_t(merged[i].len));
                s.push_back(kOpChars[merged[i].op]);
            }
            if (qlen - q1 > 0) s += std::to_string(qlen - q1) + 'H';
            s.push_back('\n');
            const int64_t row[5] = {ci, r0, r1, is_rev ? qlen - q1 : q0, is_rev ? qlen - q0 : q1};
            out->rows.insert(out->rows.end(), row, row + 5);
        };

        const int64_t p0 = ch[4], p1 = ch[4] + ch[5];
        for (int64_t pi = p0; pi < p1; ++pi) {
            const int8_t op = part_op[pi];
            if (op != kSeg) {
                runs.push_back(Run{part_len[pi], op});
                if (consumes_q(op)) q_cur += part_len[pi];
                if (consumes_r(op)) r_cur += part_len[pi];
                continue;
            }
            const int64_t* sg = segs + 5 * part_len[pi];
            int64_t kind = sg[0];
            const int64_t lq = sg[1], lr = sg[2];
            const int32_t* lens = res_lens + sg[3];
            const int8_t* ops = res_ops + sg[3];
            const int64_t n = sg[4];
            if (kind == kDp && n >= 0 && std::min(lq, lr) >= p.break_min_len) {
                // Post-DP break: a long balanced segment that aligned badly.
                int64_t matched = 0;
                for (int64_t i = 0; i < n; ++i)
                    if (ops[i] == kEq) matched += lens[i];
                if (double(matched) < p.break_min_identity * double(std::min(lq, lr)))
                    kind = kBreak;
            }
            if (kind == kBreak) {
                close(q_cur, r_cur);
                q_cur += lq;
                r_cur += lr;
                rec_q0 = q_cur;
                rec_r0 = r_cur;
                runs.clear();
                continue;
            }
            if (kind == kExtL || kind == kExtR) {
                trim_ext(runs, lens, ops, n, sc, kind == kExtL, lq, lr);
            } else {
                for (int64_t i = 0; i < n; ++i) runs.push_back(Run{lens[i], ops[i]});
            }
            q_cur += lq;
            r_cur += lr;
        }
        close(q_cur, r_cur);
    }
    return out;
}

// 0: the records (5 int64 a row: chain, r0, r1, qry_pos, qry_end); 1: the
// bytes of the CIGAR text.
int64_t pav_records_count(void* h, int32_t which) {
    Records* r = static_cast<Records*>(h);
    return which == 0 ? int64_t(r->rows.size() / 5) : int64_t(r->cigars.size());
}

void pav_records_take(void* h, int32_t which, void* out) {
    Records* r = static_cast<Records*>(h);
    if (which == 0) {
        if (!r->rows.empty()) std::memcpy(out, r->rows.data(), r->rows.size() * 8);
    } else if (!r->cigars.empty()) {
        std::memcpy(out, r->cigars.data(), r->cigars.size());
    }
}

void pav_records_free(void* h) { delete static_cast<Records*>(h); }

}  // extern "C"
