"""Batched Whisper decoding: greedy/sampled decode with whisper's logit
filters, and word timestamps from a teacher-forced alignment pass.

Port of notsofar_tpu/asr/decoding.py. The JAX package runs each decode as
one jitted ``lax.while_loop``; here it is a Python loop over steps on
device tensors, with the KV caches updated in place. The loop checks
``finished.all()`` before every step (one host sync per step); rows that
finished emit EOT and add 0 log-probability, so the step count is the
only thing the check saves.

Logit filters (pure functions of a small per-row state):

* suppress-blank at the first sampled position,
* non-speech token suppression,
* timestamp pairing rules (only text/eot after a closed pair, only
  timestamps after an open one, monotonic timestamps, forced timestamp
  when the total timestamp probability dominates, timestamp-only first
  token),
* eot latching.

Word timestamps use whisper's approach: a teacher-forced pass collecting
cross-attention from alignment heads, reduced on device (head selection,
per-frame z-norm over the real token rows, width-7 median filter, head
mean). The DTW runs on the host in float64 (the JAX package ran it on
device only to avoid its TPU host link): only the reduced [T, 1500]
matrix per window leaves the card.

Model weights live in the ``WhisperModel`` (an ``nn.Module``), so the
decoders take no ``variables`` argument.
"""
import base64
import gzip
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from notsofar_tpu_torch.asr.tokenizer import WhisperTokenizer
from notsofar_tpu_torch.models.whisper import WhisperModel

NEG_INF = -1e30


@torch.no_grad()
def detect_language(model: WhisperModel, tokenizer: WhisperTokenizer,
                    xa: torch.Tensor) -> List[str]:
    """Language identification: the distribution over language tokens at
    the position following <|startoftranscript|> (whisper detect_language).

    xa: [B, 1500, D] encoded windows -> list of language codes."""
    B = xa.shape[0]
    sot = torch.full((B, 1), tokenizer.sot, dtype=torch.long,
                     device=xa.device)
    logits, _, _ = model.decoder(sot, xa, 0, None)
    lang_items = sorted(tokenizer.specials.languages.items(),
                        key=lambda kv: kv[1])
    lang_ids = torch.tensor([i for _, i in lang_items], device=xa.device)
    best = logits[:, 0, :][:, lang_ids].argmax(dim=-1).tolist()
    return [lang_items[int(b)][0] for b in best]


def non_speech_tokens(tokenizer: WhisperTokenizer) -> List[int]:
    """Symbols suppressed during decoding (whisper's suppress_tokens='-1'):
    sound annotations, brackets, music symbols etc."""
    symbols = list("\"#()*+/:;<=>@[\\]^_`{|}~「」『』") + \
        ["<<", ">>", "<<<", ">>>", "--", "---", "-(", "-[", "('", "(\"",
         "((", "))", "(((", ")))", "[[", "]]", "{{", "}}", "♪♪", "♪♪♪",
         "♩", "♪", "♫", "♬", "♭", "♮", "♯"]
    ids = set()
    for s in symbols:
        for variant in (s, " " + s):
            toks = tokenizer.encode(variant)
            if len(toks) == 1:
                ids.add(toks[0])
    return sorted(ids)


@dataclass(frozen=True)
class DecodeOptions:
    max_new_tokens: int = 224
    language: str = "en"
    without_timestamps: bool = False
    max_initial_timestamp: float = 1.0
    suppress_blank: bool = True
    suppress_non_speech: bool = True
    temperature: float = 0.0  # >0 -> gumbel sampling (fallback ladder)
    # rows per decode call (beam paths count batch*K): bounds the per-row
    # cross-attention K/V (~0.25 GB per row on large-v3 in bf16)
    max_rows_per_dispatch: int = 12


def gumbel_noise(shape, generator: torch.Generator,
                 device: torch.device) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)), u uniform in [tiny, 1), drawn
    from ``generator`` (jax.random.gumbel's construction)."""
    u = torch.rand(shape, generator=generator, device=device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


class GreedyDecoder:
    """Batched greedy (or temperature-sampled) decoder bound to a model and
    tokenizer."""

    def __init__(self, model: WhisperModel, tokenizer: WhisperTokenizer,
                 options: DecodeOptions = DecodeOptions()):
        self.model = model
        self.tok = tokenizer
        self.opt = options
        d = model.dims
        mask = np.zeros(d.n_vocab, np.float32)
        if options.suppress_non_speech:
            for t in non_speech_tokens(tokenizer):
                mask[t] = NEG_INF
        for t in (tokenizer.specials.translate, tokenizer.specials.transcribe,
                  tokenizer.sot, tokenizer.specials.sot_prev,
                  tokenizer.specials.sot_lm, tokenizer.no_speech):
            if t < d.n_vocab:
                mask[t] = NEG_INF
        for lang_tok in tokenizer.specials.languages.values():
            if lang_tok < d.n_vocab:
                mask[lang_tok] = NEG_INF
        if not options.without_timestamps:
            mask[tokenizer.no_timestamps] = NEG_INF
        blank = np.zeros(d.n_vocab, np.float32)
        if options.suppress_blank:
            for t in tokenizer.encode(" ") + [tokenizer.eot]:
                blank[t] = NEG_INF
        self._ts_begin = tokenizer.timestamp_begin
        self._eot = tokenizer.eot
        self._max_initial_ts = self._ts_begin + int(
            options.max_initial_timestamp / 0.02)
        dev = model.device
        vocab = torch.arange(d.n_vocab, device=dev)
        self._suppress = torch.from_numpy(mask).to(dev)
        self._suppress_blank = torch.from_numpy(blank).to(dev)
        self._is_ts = vocab >= self._ts_begin
        self._is_text = vocab < self._eot
        self._vocab = vocab
        self._bad_first = ~self._is_ts | (vocab > self._max_initial_ts)

    # ------------------------------------------------------------------
    def _apply_timestamp_rules(self, logits, prev_was_ts, prev_prev_was_ts,
                               last_ts, any_ts, step: int):
        """whisper ApplyTimestampRules on a [B, V] logits batch.

        * after a closing timestamp pair -> timestamps suppressed;
          after an opening timestamp -> text (ids < eot) suppressed;
        * timestamps never decrease: suppress ts < last (an open pair may
          repeat the same value, else strictly greater);
        * first sampled token must be a timestamp <= max_initial_timestamp
          (eot suppressed too);
        * if the summed timestamp probability exceeds the best text
          token's, text (everything below timestamp_begin) is suppressed.
        """
        is_ts = self._is_ts[None, :]
        only_text = prev_was_ts & prev_prev_was_ts     # just closed a pair
        open_pair = prev_was_ts & ~prev_prev_was_ts    # must close the pair
        logits = logits.masked_fill(only_text[:, None] & is_ts, NEG_INF)
        logits = logits.masked_fill(open_pair[:, None] & self._is_text[None],
                                    NEG_INF)
        threshold = torch.where(open_pair, last_ts, last_ts + 1)
        below = self._vocab[None, :] < threshold[:, None]
        logits = logits.masked_fill(any_ts[:, None] & is_ts & below, NEG_INF)
        if step == 0:
            logits = logits.masked_fill(self._bad_first[None, :], NEG_INF)
        logprobs = torch.log_softmax(logits, dim=-1)
        ts_lp = torch.logsumexp(logprobs.masked_fill(~is_ts, NEG_INF), dim=-1)
        text_lp = logprobs.masked_fill(is_ts, NEG_INF).amax(dim=-1)
        force_ts = ts_lp > text_lp
        return logits.masked_fill(force_ts[:, None] & ~is_ts, NEG_INF)

    def _filter(self, cur_logits, state: Dict, step: int) -> torch.Tensor:
        """The logit filters every decode step applies before choosing."""
        lg = cur_logits + self._suppress
        if step == 0:
            lg = lg + self._suppress_blank
        if not self.opt.without_timestamps:
            lg = self._apply_timestamp_rules(
                lg, state["prev_was_ts"], state["prev_prev_was_ts"],
                state["last_ts"], state["any_ts"], step)
        return lg

    def _init_state(self, rows: int) -> Dict:
        dev = self.model.device
        return dict(
            prev_was_ts=torch.zeros(rows, dtype=torch.bool, device=dev),
            prev_prev_was_ts=torch.zeros(rows, dtype=torch.bool, device=dev),
            last_ts=torch.full((rows,), self._ts_begin, dtype=torch.long,
                               device=dev),
            any_ts=torch.zeros(rows, dtype=torch.bool, device=dev),
            length=torch.zeros(rows, dtype=torch.long, device=dev),
            finished=torch.zeros(rows, dtype=torch.bool, device=dev))

    def _sot_pos(self, prompt_len: int) -> int:
        """Index of <|startoftranscript|> in a prompt that ends with the
        sot sequence (where whisper reads the no-speech probability)."""
        return prompt_len - 1 - (2 if len(self.tok.sot_sequence) == 3
                                 else 0)

    @torch.no_grad()
    def _decode_loop(self, xa: torch.Tensor, prompt_len: int,
                     prompt_tokens: torch.Tensor,
                     generator: Optional[torch.Generator] = None,
                     temperature: float = 0.0,
                     pad_lens: Optional[torch.Tensor] = None,
                     row_generators: Optional[Sequence[torch.Generator]]
                     = None) -> Tuple[torch.Tensor, torch.Tensor]:
        """xa: [B, 1500, D]; prompt_tokens: [B, prompt_len].

        temperature > 0 samples with the gumbel trick (whisper's fallback
        path) from ``generator`` ([B, V] noise per step) or, when given,
        from one generator per row ([V] noise per row per step, so a row
        draws as a B=1 decode with that generator would); temperature 0 is
        greedy argmax. pad_lens: optional [B] int32 — per-row prompts
        RIGHT-ALIGNED in the prompt_len bucket with pad_lens[b] masked
        left-pad slots. Returns (tokens [B, max_new] int64, stats [B, 3] =
        sum_logprob || length || no_speech_prob)."""
        model, tok = self.model, self.tok
        dev = xa.device
        B = xa.shape[0]
        # the self-KV cache is sized to what this decode can write (prompt
        # + max_new rounded up to 64): every step reads the whole cache
        budget = min(self.opt.max_new_tokens,
                     model.dims.n_text_ctx - prompt_len) + prompt_len
        cache_len = min(-(-budget // 64) * 64, model.dims.n_text_ctx)
        caches = model.empty_kv_caches(B, cache_len=cache_len)
        cross_kvs = model.precompute_cross_kv(xa)
        logits, caches, _ = model.decoder(prompt_tokens, xa, 0, caches,
                                          cross_kvs=cross_kvs,
                                          pad_lens=pad_lens)
        no_speech_prob = torch.softmax(
            logits[:, self._sot_pos(prompt_len)], dim=-1)[:, tok.no_speech]
        cur_logits = logits[:, -1]

        # never run the cache past n_text_ctx
        max_new = min(self.opt.max_new_tokens,
                      model.dims.n_text_ctx - prompt_len)
        tokens_buf = torch.full((B, max_new), self._eot, dtype=torch.long,
                                device=dev)
        st = self._init_state(B)
        sum_lp = torch.zeros(B, dtype=torch.float32, device=dev)
        sample = temperature > 0 and (generator is not None
                                      or row_generators is not None)
        step = 0
        # early exit once every row latched EOT (one host sync per step)
        while step < max_new and not bool(st["finished"].all()):
            lg = self._filter(cur_logits, st, step)
            if sample:
                if row_generators is not None:
                    g = torch.stack([gumbel_noise(lg.shape[-1], gen, dev)
                                     for gen in row_generators])
                else:
                    g = gumbel_noise(lg.shape, generator, dev)
                next_tok = torch.argmax(lg / temperature + g, dim=-1)
            else:
                next_tok = torch.argmax(lg, dim=-1)
            # score from the post-filter renormalized distribution
            # (whisper's, and the beam path's)
            lp = torch.log_softmax(lg, dim=-1)
            tok_lp = lp.gather(1, next_tok[:, None])[:, 0]
            finished = st["finished"]
            next_tok = next_tok.masked_fill(finished, self._eot)
            is_eot = next_tok == self._eot
            sum_lp = sum_lp + tok_lp.masked_fill(finished, 0.0)
            st["length"] = st["length"] + (~(finished | is_eot)).long()
            new_finished = finished | is_eot
            is_ts = (next_tok >= self._ts_begin) & ~new_finished
            st["last_ts"] = torch.where(is_ts, next_tok, st["last_ts"])
            st["any_ts"] = st["any_ts"] | is_ts
            st["prev_prev_was_ts"] = st["prev_was_ts"]
            st["prev_was_ts"] = is_ts
            st["finished"] = new_finished
            tokens_buf[:, step] = next_tok
            new_logits, caches, _ = model.decoder(
                next_tok[:, None], xa, prompt_len + step, caches,
                cross_kvs=cross_kvs, pad_lens=pad_lens)
            cur_logits = new_logits[:, 0]
            step += 1
        stats = torch.stack([sum_lp, st["length"].float(), no_speech_prob],
                            dim=1)
        return tokens_buf, stats

    # ------------------------------------------------------------------
    def _initial_tokens(self, prompt: Optional[Sequence[int]]) -> List[int]:
        """sot_prev + the prompt's last n_text_ctx//2 - 1 tokens, then the
        sot sequence (whisper's condition_on_previous_text)."""
        tok = self.tok
        prefix = list(prompt) if prompt else []
        if prefix:
            prefix = [tok.specials.sot_prev] + \
                prefix[-(self.model.dims.n_text_ctx // 2 - 1):]
        return prefix + tok.sot_sequence

    def decode(self, xa: torch.Tensor,
               prompt: Optional[Sequence[int]] = None,
               temperature: float = 0.0,
               generator: Optional[torch.Generator] = None) -> Dict:
        """Greedy (or temperature-sampled) decode of a batch of windows.

        prompt: optional previous-context token ids (prepended with
        sot_prev per whisper's condition_on_previous_text).
        Returns dict: tokens (lists), avg_logprob, no_speech_prob (numpy).
        """
        initial = self._initial_tokens(prompt)
        B = xa.shape[0]
        if temperature > 0 and generator is None:
            generator = torch.Generator(device=xa.device).manual_seed(0)
        cap = max(self.opt.max_rows_per_dispatch, 1)
        outs = []
        for c0 in range(0, B, cap):
            xa_c = xa[c0:c0 + cap]
            prompt_tokens = torch.tensor(initial, dtype=torch.long,
                                         device=xa.device
                                         ).repeat(xa_c.shape[0], 1)
            t, s = self._decode_loop(xa_c, len(initial), prompt_tokens,
                                     generator, float(temperature))
            outs.append((t.cpu().numpy(), s.cpu().numpy()))
        tokens = np.concatenate([t for t, _ in outs])
        stats = np.concatenate([s for _, s in outs])
        return self._unpack_decode(tokens, stats)

    def _unpack_decode(self, tokens: np.ndarray, stats: np.ndarray) -> Dict:
        sum_lp, length, nsp = stats[:, 0], stats[:, 1], stats[:, 2]
        avg_lp = sum_lp / np.maximum(length + 1, 1)
        out_tokens = []
        for b in range(tokens.shape[0]):
            t = tokens[b]
            end = np.argmax(t == self._eot) if (t == self._eot).any() \
                else len(t)
            out_tokens.append(t[:end].tolist())
        return dict(tokens=out_tokens, avg_logprob=avg_lp,
                    no_speech_prob=nsp)

    def _pack_prompts(self, prompts: Sequence[Optional[Sequence[int]]]
                      ) -> Tuple[np.ndarray, np.ndarray, int]:
        """Right-align per-row prompt prefixes in a power-of-two bucket.
        Returns (tokens [B, P_pad], pad_lens [B], P_pad)."""
        prefixes = [self._initial_tokens(pr) for pr in prompts]
        P = max(len(p) for p in prefixes)
        P_pad = 1 << max(2, (P - 1).bit_length())
        toks = np.full((len(prefixes), P_pad), self.tok.sot, np.int64)
        pads = np.zeros(len(prefixes), np.int32)
        for b, p in enumerate(prefixes):
            toks[b, P_pad - len(p):] = p
            pads[b] = P_pad - len(p)
        return toks, pads, P_pad

    @staticmethod
    def _concat_results(outs: List[Dict]) -> Dict:
        return dict(
            tokens=[t for o in outs for t in o["tokens"]],
            avg_logprob=np.concatenate([o["avg_logprob"] for o in outs]),
            no_speech_prob=np.concatenate(
                [o["no_speech_prob"] for o in outs]))

    def decode_prompted(self, xa: torch.Tensor,
                        prompts: Sequence[Optional[Sequence[int]]],
                        temperature: float = 0.0,
                        generator: Optional[torch.Generator] = None,
                        generators: Optional[Sequence[torch.Generator]]
                        = None) -> Dict:
        """Batched decode with a DIFFERENT prompt per row
        (condition_on_previous_text across streams): prompts are
        right-aligned in a power-of-two bucket with masked left-pad, so
        the whole batch runs as one loop. Batches larger than
        max_rows_per_dispatch split into chunks.

        Same contract as decode(); equal to per-row decode() at
        temperature 0. generators: optional per-row generators — row b
        samples exactly as a B=1 decode with generators[b]; generator: one
        generator for the whole batch."""
        B = xa.shape[0]
        cap = max(self.opt.max_rows_per_dispatch, 1)
        if B > cap:
            return self._concat_results([
                self.decode_prompted(
                    xa[c0:c0 + cap], list(prompts)[c0:c0 + cap],
                    temperature, generator,
                    list(generators)[c0:c0 + cap]
                    if generators is not None else None)
                for c0 in range(0, B, cap)])
        toks, pads, P_pad = self._pack_prompts(prompts)
        if temperature > 0 and generator is None and generators is None:
            generator = torch.Generator(device=xa.device).manual_seed(0)
        dev = xa.device
        tokens, stats = self._decode_loop(
            xa, P_pad, torch.from_numpy(toks).to(dev), generator,
            float(temperature), pad_lens=torch.from_numpy(pads).to(dev),
            row_generators=generators)
        return self._unpack_decode(tokens.cpu().numpy(),
                                   stats.cpu().numpy())


# --------------------------------------------------------------------------
# word-level timestamps (teacher-forced cross-attention + DTW)
# --------------------------------------------------------------------------

def dtw_path(cost: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Monotonic DTW over cost [N, M] in float64; returns the alignment
    path (text indices, time indices).

    The DP D[i, j] = cost + min(D[i-1, j-1], D[i-1, j], D[i, j-1]) runs
    one anti-diagonal at a time (every cell of a diagonal depends only on
    the two before it), so each of the N+M-1 diagonals is one vectorized
    numpy step. Ties break as in the JAX package's reference DP:
    diagonal <= up < left."""
    N, M = cost.shape
    c = np.asarray(cost, np.float64)
    D = np.full((N + 1, M + 1), np.inf)
    D[0, 0] = 0.0
    trace = np.zeros((N + 1, M + 1), np.int8)
    for k in range(2, N + M + 1):         # i + j == k, 1 <= i <= N, 1 <= j <= M
        i = np.arange(max(1, k - M), min(N, k - 1) + 1)
        j = k - i
        c0, c1, c2 = D[i - 1, j - 1], D[i - 1, j], D[i, j - 1]
        diag = (c0 <= c1) & (c0 <= c2)
        up = ~diag & (c1 < c2)
        D[i, j] = c[i - 1, j - 1] + np.where(diag, c0,
                                             np.where(up, c1, c2))
        trace[i, j] = np.where(diag, 0, np.where(up, 1, 2))
    i, j = N, M
    text_idx, time_idx = [], []
    while i > 0 and j > 0:
        text_idx.append(i - 1)
        time_idx.append(j - 1)
        t = trace[i, j]
        if t == 0:
            i, j = i - 1, j - 1
        elif t == 1:
            i -= 1
        else:
            j -= 1
    return np.array(text_idx[::-1]), np.array(time_idx[::-1])


def dtw_token_starts(neg_cost: np.ndarray, n_rows: int,
                     n_cols: int) -> np.ndarray:
    """Each token row's first DTW path frame over neg_cost[:n_rows,
    :n_cols] (the only DTW output word timing needs). Rows the path never
    visits read n_cols."""
    T = neg_cost.shape[0]
    tstart = np.full(T, float(n_cols))
    if n_rows > 0 and n_cols > 0:
        ti, tj = dtw_path(neg_cost[:n_rows, :n_cols])
        for a, b in zip(ti[::-1], tj[::-1]):
            tstart[a] = b
    return tstart


def decode_alignment_heads(blob: str, n_text_layer: int,
                           n_text_head: int) -> List[Tuple[int, int]]:
    """Decode whisper's compact alignment-heads mask: a base85-encoded
    gzipped [n_text_layer, n_text_head] boolean mask selecting the
    cross-attention heads whose maps are reliable for DTW word alignment.
    Returns the selected (layer, head) pairs."""
    arr = np.frombuffer(gzip.decompress(base64.b85decode(blob)),
                        dtype=bool).copy()
    arr = arr.reshape(n_text_layer, n_text_head)
    ls, hs = np.nonzero(arr)
    return list(zip(ls.tolist(), hs.tolist()))


PREPEND_PUNCTUATIONS = "\"'“¿([{-"
APPEND_PUNCTUATIONS = "\"'.。,，!！?？:：”)]}、"


def merge_punctuations(words: List[Dict],
                       prepended: str = PREPEND_PUNCTUATIONS,
                       appended: str = APPEND_PUNCTUATIONS) -> List[Dict]:
    """Fold standalone punctuation 'words' into their neighbors (whisper's
    timing.merge_punctuations): a leading-space punctuation mark merges
    into the FOLLOWING word (keeping the follower's times), a bare
    punctuation mark merges into the PRECEDING word (keeping that word's
    times)."""
    ws = [dict(w) for w in words]

    def _absorb(dst, src):
        # the absorbing word inherits the punctuation's tokens (the emptied
        # entry keeps no tokens and is skipped by distribution)
        dst["n_tokens"] = dst.get("n_tokens", 1) + src.get("n_tokens", 1)
        src["n_tokens"] = 0

    # prepended punctuation: scan backwards
    i, j = len(ws) - 2, len(ws) - 1
    while i >= 0:
        prev, foll = ws[i], ws[j]
        if prev["word"].startswith(" ") and prev["word"].strip() in prepended:
            foll["word"] = prev["word"] + foll["word"]
            _absorb(foll, prev)
            prev["word"] = ""
        else:
            j = i
        i -= 1
    # appended punctuation: scan forwards
    i, j = 0, 1
    while j < len(ws):
        prev, foll = ws[i], ws[j]
        if not prev["word"].endswith(" ") and foll["word"] in appended:
            prev["word"] = prev["word"] + foll["word"]
            _absorb(prev, foll)
            foll["word"] = ""
        else:
            i = j
        j += 1
    return [w for w in ws if w["word"]]


def _median7(x: torch.Tensor) -> torch.Tensor:
    """Width-7 median along the last axis, edge padded."""
    xp = torch.cat([x[..., :1].expand(*x.shape[:-1], 3), x,
                    x[..., -1:].expand(*x.shape[:-1], 3)], dim=-1)
    return xp.unfold(-1, 7, 1).median(dim=-1).values


def _znorm_median(w: torch.Tensor, n_real: torch.Tensor) -> torch.Tensor:
    """w [B, H, T, F]: z-norm per (head, frame) over each row's real token
    rows, width-7 median along frames, summed over heads -> [B, T, F]."""
    mask = (torch.arange(w.shape[-2], device=w.device)[None, :]
            < n_real[:, None])[:, None, :, None]
    cnt = n_real.clamp_min(1).float()[:, None, None, None]
    mean = torch.where(mask, w, 0.0).sum(-2, keepdim=True) / cnt
    var = torch.where(mask, (w - mean) ** 2, 0.0).sum(-2, keepdim=True) / cnt
    wn = (w - mean) / (torch.sqrt(var) + 1e-9)
    return _median7(wn).sum(dim=1)


@torch.no_grad()
def _alignment_pass(model: WhisperModel, heads_key, eot: int,
                    toks: torch.Tensor, xa: torch.Tensor,
                    n_real: torch.Tensor) -> Tuple[torch.Tensor,
                                                   torch.Tensor]:
    """Batched teacher-forced alignment pass, reduced on device: the
    decoder's cross-attention from the selected heads, z-normed per
    (head, frame) over the real token rows, width-7 median filtered per
    head, averaged over heads; plus each next token's probability under
    the text-vocabulary softmax. The median filter sees the full
    1500-frame width, as in the JAX package.

    toks [B, L]; xa [B, 1500, D]; n_real [B]. Returns (matrix [B, L, F]
    f32, next-token probabilities [B, L-1])."""
    kind, sel = heads_key
    logits, _, cross = model.decoder(toks, xa, 0, None,
                                     return_cross_attn=True)
    if kind == "heads":
        per_layer: Dict[int, List[int]] = {}
        for l, h in sel:
            per_layer.setdefault(l, []).append(h)
        acc = 0.0
        for l, hs in per_layer.items():
            acc = acc + _znorm_median(cross[l][:, hs], n_real)
        matrix = acc / len(sel)
    else:
        acc = 0.0
        n_heads = 0
        for i in sel:
            acc = acc + _znorm_median(cross[i], n_real)
            n_heads += cross[i].shape[1]
        matrix = acc / n_heads
    probs = torch.softmax(logits[..., :eot], dim=-1)
    nxt = toks[:, 1:].clamp(0, eot - 1)
    tok_probs = probs[:, :-1].gather(2, nxt[..., None])[..., 0]
    return matrix, tok_probs


def find_word_timestamps(model: WhisperModel, tokenizer: WhisperTokenizer,
                         xa_single: torch.Tensor, text_tokens: List[int],
                         num_frames: int, time_offset: float = 0.0,
                         alignment_layers: Optional[List[int]] = None,
                         alignment_heads: Optional[List[Tuple[int, int]]]
                         = None, merge: bool = True) -> List[Dict]:
    """Teacher-forced pass + DTW ->
    [{'word','start','end','probability','n_tokens'} ...] for one window
    (xa_single [1, 1500, D]). See find_word_timestamps_batch."""
    return find_word_timestamps_batch(
        model, tokenizer, [xa_single], [text_tokens], [num_frames],
        [time_offset], alignment_layers=alignment_layers,
        alignment_heads=alignment_heads, merge=merge)[0]


# sub-batch cap per alignment call: one layer's cross-attention is
# [B, n_head, L, 1500] f32 and every layer's is kept for the reduction
_ALIGN_MAX_BS_LAYERS = 12
_ALIGN_MAX_BS_HEADS = 24


def find_word_timestamps_batch(model: WhisperModel,
                               tokenizer: WhisperTokenizer,
                               xa_list: List[torch.Tensor],
                               text_tokens_list: List[List[int]],
                               num_frames_list: List[int],
                               time_offsets: Optional[List[float]] = None,
                               alignment_layers: Optional[List[int]] = None,
                               alignment_heads: Optional[List[Tuple[int, int]]]
                               = None, merge: bool = True
                               ) -> List[List[Dict]]:
    """Batched word timestamps over many (window, tokens) pairs.

    Items are bucketed by padded token length (eot padding; causality
    keeps the real prefix rows unchanged) and chunked to bound the
    cross-attention memory. alignment_heads: optional per-model
    (layer, head) selection (see decode_alignment_heads); without it all
    heads of the last half of the layers are used (whisper's default for
    models without a mask). merge=False returns the raw per-word
    alignment, so the caller can run the duration hacks before
    merge_punctuations as whisper's add_word_timestamps does."""
    d = model.dims
    if alignment_heads:
        alignment_layers = sorted({l for l, _ in alignment_heads})
    elif alignment_layers is None:
        alignment_layers = list(range(d.n_text_layer // 2, d.n_text_layer))
    if time_offsets is None:
        time_offsets = [0.0] * len(xa_list)
    heads_key = (("heads", tuple((int(l), int(h))
                                 for l, h in alignment_heads))
                 if alignment_heads else
                 ("layers", tuple(int(i) for i in alignment_layers)))
    max_bs = _ALIGN_MAX_BS_HEADS if alignment_heads else \
        _ALIGN_MAX_BS_LAYERS
    sot_len = len(tokenizer.sot_sequence) + 1
    eot = int(tokenizer.eot)

    items = []
    for i, text_tokens in enumerate(text_tokens_list):
        full = tokenizer.sot_sequence + [tokenizer.no_timestamps] + \
            list(text_tokens) + [tokenizer.eot]
        L = len(full)
        pad_to = min(max(32, 1 << (L - 1).bit_length()), d.n_text_ctx)
        if L > pad_to:
            raise ValueError(f"{L} tokens exceed the decoder context")
        items.append((pad_to, i, full, L))

    results: List[Optional[List[Dict]]] = [None] * len(xa_list)
    buckets: Dict[int, list] = {}
    for it in items:
        buckets.setdefault(it[0], []).append(it)
    for pad_to, bucket in sorted(buckets.items()):
        for c0 in range(0, len(bucket), max_bs):
            chunk = bucket[c0:c0 + max_bs]
            B = len(chunk)
            toks = np.full((B, pad_to), eot, np.int64)
            n_real = np.zeros(B, np.int64)
            for j, (_, i, full, L) in enumerate(chunk):
                toks[j, :L] = full
                n_real[j] = L
            xa = torch.cat([xa_list[i] for _, i, _, _ in chunk], dim=0)
            dev = xa.device
            matrix, probs = _alignment_pass(
                model, heads_key, eot, torch.from_numpy(toks).to(dev), xa,
                torch.from_numpy(n_real).to(dev))
            # DTW rows: the text-token slice of each item's matrix
            rows = (-matrix[:, sot_len:-1]).cpu().numpy()
            probs = probs.cpu().numpy()
            for j, (_, i, full, L) in enumerate(chunk):
                n_text = len(text_tokens_list[i])
                tstart = dtw_token_starts(rows[j], L - sot_len - 1,
                                          num_frames_list[i] // 2)
                results[i] = _finish_word_timestamps(
                    tstart[:n_text], probs[j], tokenizer,
                    text_tokens_list[i], num_frames_list[i],
                    time_offsets[i], merge)
    return results


def _finish_word_timestamps(tstart: np.ndarray, tok_probs: np.ndarray,
                            tokenizer: WhisperTokenizer,
                            text_tokens: List[int], num_frames: int,
                            time_offset: float, merge: bool) -> List[Dict]:
    """Host tail of the alignment: token start frames -> word dicts.

    tstart: [n_text] each token row's first DTW path frame; tok_probs:
    next-token probabilities under the text-vocabulary softmax (whisper
    timing.find_alignment), averaged over a word's tokens for its
    probability — which feeds the hallucination anomaly score."""
    n_text = len(text_tokens)
    sot_len = len(tokenizer.sot_sequence) + 1
    text_token_probs = tok_probs[sot_len - 1:sot_len - 1 + n_text]
    if n_text == 0 or num_frames // 2 == 0:
        return []

    words, word_tokens = tokenizer.split_to_word_tokens(list(text_tokens))
    if not words:
        return []
    # first path time of each token row (the 'jump' into that row), plus
    # a sentinel end time at the window's valid extent
    n_tok = n_text
    token_start = np.full(n_tok + 1, (num_frames // 2) * 0.02)
    token_start[:n_tok] = np.minimum(tstart, num_frames // 2) * 0.02
    token_start = np.maximum.accumulate(token_start)   # monotonic fill
    out = []
    pos = 0
    for word, wt in zip(words, word_tokens):
        start = token_start[min(pos, n_tok)]
        end = token_start[min(pos + len(wt), n_tok)]
        prob = float(np.mean(text_token_probs[pos:pos + len(wt)])) \
            if len(wt) and pos + len(wt) <= n_text else 0.0
        out.append(dict(word=word, start=time_offset + float(start),
                        end=time_offset + float(max(end, start)),
                        probability=prob, n_tokens=len(wt)))
        pos += len(wt)
    if merge:
        return merge_punctuations(out)
    return out
