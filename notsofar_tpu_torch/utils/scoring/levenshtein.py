"""Time-constrained Levenshtein distance (native C++ with numpy fallback).

Copy of notsofar_tpu/utils/scoring/levenshtein.py. The scoring core for
tcpWER / tcORC-WER. Runs the port's native/tclev.cpp, built and loaded at
first use by utils/native.py where a C++ compiler is available; otherwise
falls back to a vectorized numpy DP (identical results; the breakdown tie
order — diagonal, deletion, insertion — matches the C++ kernel).
"""
from dataclasses import dataclass

import numpy as np

from notsofar_tpu_torch.utils.native import load_native, ptr


def core_name() -> str:
    """Which core the scorer runs: 'native' (native/tclev.cpp) or 'numpy'."""
    return "native" if load_native("tclev") is not None else "numpy"


@dataclass
class EditCounts:
    errors: int
    substitutions: int
    insertions: int
    deletions: int


def tc_levenshtein(ref_ids: np.ndarray, ref_beg: np.ndarray,
                   ref_end: np.ndarray, hyp_ids: np.ndarray,
                   hyp_beg: np.ndarray, hyp_end: np.ndarray) -> EditCounts:
    """Time-constrained edit distance with error breakdown.

    ref intervals must already include any collar extension. Matching or
    substituting ref[i] with hyp[j] is allowed only when the intervals
    strictly overlap (beg1 < end2 and beg2 < end1).
    """
    ref_ids = np.ascontiguousarray(ref_ids, np.int32)
    hyp_ids = np.ascontiguousarray(hyp_ids, np.int32)
    ref_beg = np.ascontiguousarray(ref_beg, np.float64)
    ref_end = np.ascontiguousarray(ref_end, np.float64)
    hyp_beg = np.ascontiguousarray(hyp_beg, np.float64)
    hyp_end = np.ascontiguousarray(hyp_end, np.float64)
    n, m = len(ref_ids), len(hyp_ids)
    lib = load_native("tclev")
    if lib is not None:
        out = np.zeros(4, np.int64)
        lib.tc_levenshtein(ptr(ref_ids), ptr(ref_beg), ptr(ref_end), n,
                           ptr(hyp_ids), ptr(hyp_beg), ptr(hyp_end), m,
                           ptr(out))
        return EditCounts(int(out[0]), int(out[1]), int(out[2]), int(out[3]))
    return _tc_lev_numpy(ref_ids, ref_beg, ref_end, hyp_ids, hyp_beg, hyp_end)


def _tc_lev_numpy(ref_ids, ref_beg, ref_end, hyp_ids, hyp_beg, hyp_end
                  ) -> EditCounts:
    """Row-rolling DP. Encodes (cost, sub, ins, del) into one int64 so a
    single lexicographic min reproduces the C++ tie order exactly is not
    needed — we track four rolling rows and resolve ties explicitly."""
    n, m = len(ref_ids), len(hyp_ids)
    BIG = np.int64(1) << 40
    cost = np.arange(m + 1, dtype=np.int64)
    sub = np.zeros(m + 1, np.int64)
    ins = np.arange(m + 1, dtype=np.int64)
    dele = np.zeros(m + 1, np.int64)
    for i in range(1, n + 1):
        allowed = (ref_beg[i - 1] < hyp_end) & (hyp_beg < ref_end[i - 1])
        is_sub = (hyp_ids != ref_ids[i - 1]).astype(np.int64)
        # candidate: diagonal
        diag_cost = cost[:-1] + np.where(allowed, is_sub, BIG)
        diag_sub = sub[:-1] + np.where(allowed, is_sub, 0)
        diag_ins, diag_del = ins[:-1], dele[:-1]
        # candidate: deletion (from previous row, same column)
        del_cost, del_sub = cost[1:] + 1, sub[1:]
        del_ins, del_del = ins[1:], dele[1:] + 1
        # merge diag/del (diag wins ties)
        use_diag = diag_cost <= del_cost
        ncost = np.where(use_diag, diag_cost, del_cost)
        nsub = np.where(use_diag, diag_sub, del_sub)
        nins = np.where(use_diag, diag_ins, del_ins)
        ndel = np.where(use_diag, diag_del, del_del)
        # insertions need a sequential pass (left-to-right dependency)
        ccost = np.empty(m + 1, np.int64)
        csub = np.empty(m + 1, np.int64)
        cins = np.empty(m + 1, np.int64)
        cdel = np.empty(m + 1, np.int64)
        ccost[0], csub[0], cins[0], cdel[0] = i, 0, 0, i
        for j in range(1, m + 1):
            ic = ccost[j - 1] + 1
            if ic < ncost[j - 1]:
                ccost[j] = ic
                csub[j] = csub[j - 1]
                cins[j] = cins[j - 1] + 1
                cdel[j] = cdel[j - 1]
            else:
                ccost[j] = ncost[j - 1]
                csub[j] = nsub[j - 1]
                cins[j] = nins[j - 1]
                cdel[j] = ndel[j - 1]
        cost, sub, ins, dele = ccost, csub, cins, cdel
    return EditCounts(int(cost[m]), int(sub[m]), int(ins[m]), int(dele[m]))


def levenshtein(ref_ids: np.ndarray, hyp_ids: np.ndarray) -> EditCounts:
    """Unconstrained edit distance with breakdown (same tie order)."""
    inf_b = np.full(len(ref_ids), -1e30)
    inf_e = np.full(len(ref_ids), 1e30)
    hb = np.zeros(len(hyp_ids))
    he = np.ones(len(hyp_ids))
    return tc_levenshtein(np.asarray(ref_ids), inf_b, inf_e,
                          np.asarray(hyp_ids), hb, he)
