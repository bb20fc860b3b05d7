"""Exact time-pruned tcORC-WER for bounded sessions (golden scorer).

Copy of notsofar_tpu/utils/scoring/exact_orc.py; the native DP is the
port's own native/orc.cpp, built into native/build/.

The production tcorc_wer (tcpwer.py:190) finds the utterance->stream
assignment by multi-start exact-rescoring local search — formally an upper
bound. This module computes the EXACT optimum for sessions whose overlap
structure is bounded, serving as the in-repo golden the test suite
certifies the production scorer against (the NOTSOFAR baseline treats
meeteval as the frozen golden; this package does not depend on meeteval).

Method — exact temporal block decomposition:
The time-constrained Levenshtein kernel only allows matching a reference
word (collar-extended interval) with a hypothesis word whose interval
STRICTLY overlaps it (levenshtein.py:80-83). Therefore, at any time point
T crossed by no collar-extended reference-word interval and no hypothesis
word interval, every alignment decomposes: cross-T matches are forbidden,
and insertions/deletions are local. Utterance assignments interact only
within such maximal "blocks" of mutually overlapping intervals, so

    exact_errors = sum over blocks of min over S^{U_block} assignments

Within a block the optimum is computed by the native multidimensional DP
(native/orc.cpp): state (ref words consumed, per-stream words consumed,
stream the current utterance is pinned to) — polynomial in the block size,
so dense chained-overlap blocks (the #DebateOverlaps regime) score exactly.
When the kernel is unavailable (no g++) the S^U assignment enumeration
runs instead, with two pruning facts keeping it feasible:
  * only streams with words inside the block are distinct choices — all
    word-free streams are interchangeable pure-deletion sinks, so one
    canonical 'empty' choice represents them;
  * blocks larger than max_block_utts raise (the session is not exactly
    scorable by enumeration).
The two formulations are differentially tested against each other
(tests/test_scoring.py::test_exact_orc_native_matches_enumeration).
"""
import itertools
from typing import Dict, List, Optional

import numpy as np

from notsofar_tpu_torch.utils.native import load_native, ptr
from notsofar_tpu_torch.utils.scoring.levenshtein import EditCounts
from notsofar_tpu_torch.utils.scoring.seglst import SegLst
from notsofar_tpu_torch.utils.scoring.tcpwer import (Vocab, WordSeq, _concat_seqs,
                                               _speaker_word_seqs, _tclev,
                                               _utterances)

def _orc_exact_native(utt_seqs: List[WordSeq], streams: List[WordSeq],
                      collar: float, max_ops: int = 2_000_000_000
                      ) -> Optional[EditCounts]:
    """Exact block optimum via the native DP (native/orc.cpp); None when
    the kernel is unavailable or the state space exceeds max_ops."""
    lib = load_native("orc")
    if lib is None:
        return None
    ids = np.concatenate([u.ids for u in utt_seqs]).astype(np.int32)
    beg = np.concatenate([u.beg for u in utt_seqs]) - collar
    end = np.concatenate([u.end for u in utt_seqs]) + collar
    utt = np.concatenate([np.full(len(u), i, np.int32)
                          for i, u in enumerate(utt_seqs)])
    h_ids = (np.concatenate([s.ids for s in streams]).astype(np.int32)
             if streams else np.zeros(0, np.int32))
    h_beg = (np.concatenate([s.beg for s in streams]) if streams
             else np.zeros(0))
    h_end = (np.concatenate([s.end for s in streams]) if streams
             else np.zeros(0))
    offsets = np.zeros(len(streams) + 1, np.int64)
    np.cumsum([len(s) for s in streams], out=offsets[1:])
    out4 = np.zeros(4, np.int64)
    c = np.ascontiguousarray
    res = lib.orc_exact(
        ptr(c(ids)), ptr(c(beg)), ptr(c(end)), ptr(c(utt)), len(ids),
        ptr(c(h_ids)), ptr(c(h_beg)), ptr(c(h_end)), ptr(c(offsets)),
        len(streams), max_ops, ptr(out4))
    if res < 0:
        return None
    return EditCounts(int(out4[0]), int(out4[1]), int(out4[2]),
                      int(out4[3]))


def _sub_seq(seq: WordSeq, idx: List[int]) -> WordSeq:
    ii = np.asarray(idx, np.int64)
    return WordSeq(seq.ids[ii], seq.beg[ii], seq.end[ii])


def _overlap_blocks(utts, streams: Dict[str, WordSeq], stream_ids,
                    collar: float) -> List[Dict]:
    """Temporal block decomposition shared by the exact scorer and the
    production scorer's certificate pass.

    Returns a list of dicts: {'utts': [utt indices], 'streams':
    {sid: WordSeq restricted to the block}} — pure-insertion blocks have
    an empty 'utts' list."""
    # interval items: (start, end, kind, payload); utterances use their
    # words' collar-extended pseudo-time extent
    items = []
    for ui, u in enumerate(utts):
        items.append((float(u.seq.beg.min()) - collar,
                      float(u.seq.end.max()) + collar, "u", ui))
    for sid in stream_ids:
        st = streams[sid]
        for wi in range(len(st)):
            items.append((float(st.beg[wi]), float(st.end[wi]), "h",
                          (sid, wi)))
    items.sort(key=lambda x: (x[0], x[1]))

    # sweep into maximal overlap blocks; the kernel's overlap test is
    # strict (beg < end), so a new item starting exactly at the current
    # block's max end cannot interact with it
    raw: List[List] = []
    cur_end = -np.inf
    for it in items:
        if not raw or it[0] >= cur_end:
            raw.append([it])
            cur_end = it[1]
        else:
            raw[-1].append(it)
            cur_end = max(cur_end, it[1])

    blocks = []
    for block in raw:
        but = sorted(ui for _, _, k, ui in block if k == "u")
        by_stream: Dict[str, List[int]] = {}
        for _, _, k, p in block:
            if k == "h":
                by_stream.setdefault(p[0], []).append(p[1])
        blocks.append(dict(
            utts=but,
            streams={sid: _sub_seq(streams[sid], sorted(wis))
                     for sid, wis in sorted(by_stream.items())}))
    return blocks


def _block_exact(utt_seqs: List[WordSeq], block_streams: Dict[str, WordSeq],
                 S_total: int, collar: float,
                 max_block_utts: Optional[int] = None
                 ) -> Optional[EditCounts]:
    """Exact optimum of one block: native multidimensional DP first,
    S^U assignment enumeration as fallback. None = infeasible (native
    kernel refused / unavailable AND enumeration would exceed
    max_block_utts; max_block_utts=None disables enumeration entirely)."""
    active = sorted(block_streams)
    # exact multidimensional DP (native/orc.cpp): polynomial in the
    # block size, so chained-overlap blocks (#DebateOverlaps regime)
    # score exactly; enumeration remains the fallback when the kernel
    # is unavailable or the block's stream product explodes
    native = _orc_exact_native(utt_seqs,
                               [block_streams[sid] for sid in active],
                               collar)
    if native is not None:
        return native
    choices: List = list(active)
    if len(active) < S_total:
        choices.append(None)   # canonical pure-deletion (empty) stream
    if len(choices) > 1 and (max_block_utts is None
                             or len(utt_seqs) > max_block_utts):
        return None
    best = None
    for assign in itertools.product(range(len(choices)),
                                    repeat=len(utt_seqs)):
        counts = []
        for ci, ch in enumerate(choices):
            refcat = _concat_seqs(
                [u for u, a in zip(utt_seqs, assign) if a == ci])
            if ch is None:
                counts.append(EditCounts(len(refcat), 0, 0, len(refcat)))
            else:
                counts.append(_tclev(refcat, block_streams[ch], collar))
        errs = sum(c.errors for c in counts)
        if best is None or errs < best[0]:
            best = (errs, counts)
    total = EditCounts(0, 0, 0, 0)
    for c in best[1]:
        total = EditCounts(total.errors + c.errors,
                           total.substitutions + c.substitutions,
                           total.insertions + c.insertions,
                           total.deletions + c.deletions)
    return total


def tcorc_wer_exact(ref: SegLst, hyp: SegLst, collar: float = 5.0,
                    max_block_utts: int = 14) -> Dict:
    """Exact tcORC-WER via temporal block decomposition.

    Raises ValueError when a block holds more than max_block_utts
    utterances with more than one distinct stream choice (enumeration
    would exceed ~S^max_block_utts)."""
    vocab = Vocab()
    streams = _speaker_word_seqs(hyp, vocab)
    stream_ids = sorted(streams)
    utts = _utterances(ref, vocab)
    S = len(stream_ids)
    length = sum(len(u.seq) for u in utts)

    if S == 0 or length == 0:
        ins = sum(len(s) for s in streams.values())
        errors = length + ins
        return dict(error_rate=errors / length if length
                    else float(errors > 0),
                    errors=errors, length=length, insertions=ins,
                    deletions=length, substitutions=0)

    tot = dict(errors=0, substitutions=0, insertions=0, deletions=0)
    for block in _overlap_blocks(utts, streams, stream_ids, collar):
        if not block["utts"]:
            # pure insertions: no utterance can claim these words
            ins = sum(len(s) for s in block["streams"].values())
            tot["errors"] += ins
            tot["insertions"] += ins
            continue
        counts = _block_exact([utts[ui].seq for ui in block["utts"]],
                              block["streams"], S, collar, max_block_utts)
        if counts is None:
            raise ValueError(
                f"block with {len(block['utts'])} utterances x "
                f"{len(block['streams']) + 1} choices exceeds "
                f"max_block_utts={max_block_utts}; session not exactly "
                "scorable by block decomposition")
        tot["errors"] += counts.errors
        tot["substitutions"] += counts.substitutions
        tot["insertions"] += counts.insertions
        tot["deletions"] += counts.deletions

    return dict(error_rate=tot["errors"] / length, length=length, **tot)


def tcorc_certificate(ref: SegLst, hyp: SegLst, collar: float = 5.0
                      ) -> Dict:
    """Certification pass for the production tcORC scorer: never raises.

    Attempts the exact block decomposition; returns
      {'exact': bool,          # every block solved to optimality
       'optimum': int | None,  # exact total errors when exact
       'n_blocks': int, 'max_block_utts': int, 'max_block_words': int,
       'infeasible_blocks': int}
    so the scorer can state whether its local-search result is the true
    optimum or only an upper bound (and on which block sizes it gave up).
    Enumeration fallback is disabled here (the native DP is the scalable
    path; certification must stay cheap on real sessions)."""
    vocab = Vocab()
    streams = _speaker_word_seqs(hyp, vocab)
    stream_ids = sorted(streams)
    utts = _utterances(ref, vocab)
    S = len(stream_ids)
    length = sum(len(u.seq) for u in utts)

    if S == 0 or length == 0:
        ins = sum(len(s) for s in streams.values())
        return dict(exact=True, optimum=length + ins, n_blocks=0,
                    max_block_utts=0, max_block_words=0,
                    infeasible_blocks=0,
                    counts=EditCounts(length + ins, 0, ins, length))

    blocks = _overlap_blocks(utts, streams, stream_ids, collar)
    tot = EditCounts(0, 0, 0, 0)
    infeasible = 0
    max_utts = 0
    max_words = 0
    for block in blocks:
        n_words = (sum(len(utts[ui].seq) for ui in block["utts"])
                   + sum(len(s) for s in block["streams"].values()))
        max_utts = max(max_utts, len(block["utts"]))
        max_words = max(max_words, n_words)
        if not block["utts"]:
            ins = sum(len(s) for s in block["streams"].values())
            tot = EditCounts(tot.errors + ins, tot.substitutions,
                             tot.insertions + ins, tot.deletions)
            continue
        counts = _block_exact([utts[ui].seq for ui in block["utts"]],
                              block["streams"], S, collar,
                              max_block_utts=10)
        if counts is None:
            infeasible += 1
        else:
            tot = EditCounts(tot.errors + counts.errors,
                             tot.substitutions + counts.substitutions,
                             tot.insertions + counts.insertions,
                             tot.deletions + counts.deletions)
    exact = infeasible == 0
    return dict(exact=exact, optimum=tot.errors if exact else None,
                n_blocks=len(blocks), max_block_utts=max_utts,
                max_block_words=max_words, infeasible_blocks=infeasible,
                counts=tot if exact else None)
