// Time-constrained Levenshtein distance — native scoring kernel.
//
// Copy of notsofar_tpu/native/tclev.cpp, used by the port's tcpWER /
// tcORC-WER scorer (notsofar_tpu_torch/utils/scoring): the NOTSOFAR baseline
// delegates this to the meeteval package, which this package does not use,
// so the metric core is implemented natively.
//
// Semantics (meeteval-aligned): edit distance between a reference and a
// hypothesis word sequence where a match/substitution between ref word i and
// hyp word j is permitted only when their time intervals overlap (the
// reference interval is pre-extended by the collar on both sides by the
// caller). Insertions and deletions cost 1, substitutions cost 1, matches 0.
//
// The DP runs over two rolling rows; alongside the cost we carry the
// (substitution, insertion, deletion) breakdown of one optimal alignment
// (ties broken: diagonal, then deletion, then insertion).
//
// Build: at first use, by utils/native.py::load_native("tclev").

#include <cstdint>
#include <vector>
#include <algorithm>
#include <limits>

namespace {

struct Cell {
    int32_t cost;
    int32_t sub, ins, del;
};

inline bool overlaps(double b1, double e1, double b2, double e2) {
    return b1 < e2 && b2 < e1;
}

}  // namespace

extern "C" {

// Returns the total distance. out4 (optional, length 4) receives
// [errors, substitutions, insertions, deletions].
int64_t tc_levenshtein(const int32_t* ref_ids, const double* ref_beg,
                       const double* ref_end, int64_t n,
                       const int32_t* hyp_ids, const double* hyp_beg,
                       const double* hyp_end, int64_t m,
                       int64_t* out4) {
    std::vector<Cell> prev(m + 1), cur(m + 1);
    for (int64_t j = 0; j <= m; ++j) prev[j] = {int32_t(j), 0, int32_t(j), 0};

    for (int64_t i = 1; i <= n; ++i) {
        cur[0] = {int32_t(i), 0, 0, int32_t(i)};
        const int32_t rid = ref_ids[i - 1];
        const double rb = ref_beg[i - 1], re = ref_end[i - 1];
        for (int64_t j = 1; j <= m; ++j) {
            // deletion of ref word (move down)
            Cell best = prev[j];
            best.cost += 1; best.del += 1;
            // insertion of hyp word (move right)
            Cell insc = cur[j - 1];
            insc.cost += 1; insc.ins += 1;
            // diagonal, only when time-permitted
            if (overlaps(rb, re, hyp_beg[j - 1], hyp_end[j - 1])) {
                Cell diag = prev[j - 1];
                const bool is_sub = (rid != hyp_ids[j - 1]);
                diag.cost += is_sub ? 1 : 0;
                diag.sub += is_sub ? 1 : 0;
                if (diag.cost <= best.cost) best = diag;
            }
            if (insc.cost < best.cost) best = insc;
            cur[j] = best;
        }
        std::swap(prev, cur);
    }
    const Cell& r = prev[m];
    if (out4 != nullptr) {
        out4[0] = r.cost;
        out4[1] = r.sub;
        out4[2] = r.ins;
        out4[3] = r.del;
    }
    return r.cost;
}

// Plain (unconstrained) Levenshtein with the same breakdown contract.
int64_t levenshtein(const int32_t* ref_ids, int64_t n,
                    const int32_t* hyp_ids, int64_t m, int64_t* out4) {
    std::vector<Cell> prev(m + 1), cur(m + 1);
    for (int64_t j = 0; j <= m; ++j) prev[j] = {int32_t(j), 0, int32_t(j), 0};
    for (int64_t i = 1; i <= n; ++i) {
        cur[0] = {int32_t(i), 0, 0, int32_t(i)};
        for (int64_t j = 1; j <= m; ++j) {
            Cell best = prev[j];
            best.cost += 1; best.del += 1;
            Cell insc = cur[j - 1];
            insc.cost += 1; insc.ins += 1;
            Cell diag = prev[j - 1];
            const bool is_sub = (ref_ids[i - 1] != hyp_ids[j - 1]);
            diag.cost += is_sub ? 1 : 0;
            diag.sub += is_sub ? 1 : 0;
            if (diag.cost <= best.cost) best = diag;
            if (insc.cost < best.cost) best = insc;
            cur[j] = best;
        }
        std::swap(prev, cur);
    }
    const Cell& r = prev[m];
    if (out4 != nullptr) {
        out4[0] = r.cost; out4[1] = r.sub; out4[2] = r.ins; out4[3] = r.del;
    }
    return r.cost;
}

}  // extern "C"
