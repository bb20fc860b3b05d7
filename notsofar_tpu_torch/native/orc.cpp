// Exact time-constrained ORC assignment — native scoring kernel.
//
// Computes the EXACT tcORC-WER optimum for one temporal block: the minimum
// over all utterance->stream assignments of the summed time-constrained
// Levenshtein errors (the quantity the NOTSOFAR baseline delegates to
// meeteval's tcorcwer). Copy of notsofar_tpu/native/orc.cpp. The Python golden
// (utils/scoring/exact_orc.py) previously enumerated S^U assignments, which
// explodes on dense-overlap sessions (#DebateOverlaps-style chained blocks);
// this kernel runs the multidimensional DP directly:
//
//   state = (i ref words consumed, j_1..j_S stream words consumed,
//            a = stream the CURRENT utterance is pinned to, or UNASSIGNED)
//   moves:
//     delete ref word i        cost 1   (stream-independent)
//     insert stream-c word j_c cost 1   (any time: unmatched stream words
//                                        are insertions in their stream's
//                                        alignment exactly once)
//     match/substitute ref word i with stream-c word j_c
//                              cost 0/1, allowed iff the collar-extended
//                              ref interval STRICTLY overlaps the hyp
//                              interval AND a \in {UNASSIGNED, c}; pins
//                              a := c until the utterance boundary
//
// Every DP path induces an assignment + valid per-stream monotone
// alignments and vice versa, so the optimum equals the assignment-
// enumeration optimum (differentially tested against it in
// tests/test_scoring_golden.py). Complexity O(n * prod(L_c+1) * (S+1) * S)
// instead of O(S^U); work is capped by max_ops (returns -1 => caller
// falls back).
//
// Build: at first use, by utils/native.py::load_native("orc").

#include <cstdint>
#include <vector>
#include <algorithm>
#include <limits>

namespace {

struct Cell {
    int32_t cost;
    int32_t sub, ins, del;
};

const int32_t INF = std::numeric_limits<int32_t>::max() / 4;

inline bool overlaps(double b1, double e1, double b2, double e2) {
    return b1 < e2 && b2 < e1;
}

inline void relax(Cell& dst, const Cell& src) {
    if (src.cost < dst.cost) dst = src;
}

}  // namespace

extern "C" {

// Exact block tcORC. ref arrays hold the utterance-concatenated reference
// words with collar-extended intervals; ref_utt[i] is word i's utterance
// index (non-decreasing). Streams are flattened: hyp_* arrays with
// offsets[S+1] delimiting each stream. out4 receives
// [errors, substitutions, insertions, deletions] of one optimal alignment.
// Returns total errors, or -1 when n * prod(L_c+1) * (S+1) work would
// exceed max_ops (caller falls back to enumeration / raises).
int64_t orc_exact(const int32_t* ref_ids, const double* ref_beg,
                  const double* ref_end, const int32_t* ref_utt, int64_t n,
                  const int32_t* hyp_ids, const double* hyp_beg,
                  const double* hyp_end, const int64_t* offsets, int64_t S,
                  int64_t max_ops, int64_t* out4) {
    std::vector<int64_t> L(S), stride(S);
    int64_t J = 1;
    for (int64_t c = 0; c < S; ++c) L[c] = offsets[c + 1] - offsets[c];
    // row-major: stride of the LAST stream is 1 (so +e_last is +1)
    for (int64_t c = S - 1; c >= 0; --c) {
        stride[c] = J;
        J *= (L[c] + 1);
    }
    const int64_t A = S + 1;               // a = S means UNASSIGNED
    const int64_t layer_sz = J * A;
    const int64_t ops = (n + 1) * layer_sz * (2 * S + 2);
    if (ops > max_ops || layer_sz > max_ops) return -1;
    // explicit memory cap: max_ops bounds WORK but only loosely bounds the
    // two DP layers' allocation (few ref words x huge stream-length product
    // can pass the ops check yet want gigabytes); refuse instead of OOMing
    // so the caller falls back to enumeration / raises a clean error
    const int64_t kMemCapBytes = 384LL << 20;   // 384 MB for both layers
    if (layer_sz > kMemCapBytes / (2 * (int64_t)sizeof(Cell))) return -1;

    std::vector<Cell> cur(layer_sz, {INF, 0, 0, 0});
    std::vector<Cell> nxt(layer_sz);
    std::vector<int64_t> jvec(S);

    // in-layer insertion relaxation: increasing flat j order is a valid
    // topological order for the +e_c moves
    auto relax_ins = [&](std::vector<Cell>& layer) {
        for (int64_t j = 0; j < J; ++j) {
            // decode j to know which streams can still insert
            int64_t rem = j;
            for (int64_t c = 0; c < S; ++c) {
                jvec[c] = rem / stride[c];
                rem %= stride[c];
            }
            for (int64_t c = 0; c < S; ++c) {
                if (jvec[c] >= L[c]) continue;
                const int64_t j2 = j + stride[c];
                for (int64_t a = 0; a < A; ++a) {
                    Cell s = layer[j * A + a];
                    if (s.cost >= INF) continue;
                    s.cost += 1; s.ins += 1;
                    relax(layer[j2 * A + a], s);
                }
            }
        }
    };

    cur[0 * A + S] = {0, 0, 0, 0};
    relax_ins(cur);

    for (int64_t i = 0; i < n; ++i) {
        std::fill(nxt.begin(), nxt.end(), Cell{INF, 0, 0, 0});
        // does consuming ref word i end its utterance?
        const bool boundary = (i + 1 == n) || (ref_utt[i + 1] != ref_utt[i]);
        const int32_t rid = ref_ids[i];
        const double rb = ref_beg[i], re = ref_end[i];
        for (int64_t j = 0; j < J; ++j) {
            int64_t rem = j;
            for (int64_t c = 0; c < S; ++c) {
                jvec[c] = rem / stride[c];
                rem %= stride[c];
            }
            for (int64_t a = 0; a < A; ++a) {
                const Cell& s = cur[j * A + a];
                if (s.cost >= INF) continue;
                // delete ref word i (stream-independent)
                {
                    Cell d = s;
                    d.cost += 1; d.del += 1;
                    const int64_t a2 = boundary ? S : a;
                    relax(nxt[j * A + a2], d);
                }
                // match/substitute with stream c's next word
                for (int64_t c = 0; c < S; ++c) {
                    if (a != S && a != c) continue;
                    if (jvec[c] >= L[c]) continue;
                    const int64_t w = offsets[c] + jvec[c];
                    if (!overlaps(rb, re, hyp_beg[w], hyp_end[w])) continue;
                    Cell m = s;
                    if (hyp_ids[w] != rid) { m.cost += 1; m.sub += 1; }
                    const int64_t a2 = boundary ? S : c;
                    relax(nxt[(j + stride[c]) * A + a2], m);
                }
            }
        }
        relax_ins(nxt);
        std::swap(cur, nxt);
    }

    Cell best = {INF, 0, 0, 0};
    for (int64_t a = 0; a < A; ++a) relax(best, cur[(J - 1) * A + a]);
    if (out4 != nullptr) {
        out4[0] = best.cost;
        out4[1] = best.sub;
        out4[2] = best.ins;
        out4[3] = best.del;
    }
    return best.cost;
}

}  // extern "C"
