"""Plain float32 Whisper, written from the openai-whisper model description,
for the benchmark's output check.

It imports nothing of the measured program. The weights are the
benchmark's own (openai checkpoint layout, as ``param_specs`` lists them),
widened to float32 one layer at a time when used; every matmul runs in
float32 with TF32 off (``f32_matmuls``). ``Weights(..., lowp=True)`` rounds
every matmul's operands to float8 e4m3 (``fp8``): the check's control.

* ``log_mel``: whisper's log-mel frontend (``torch.stft``, periodic Hann,
  the Slaney mel filterbank, log10, a dynamic-range clamp of 8 over each
  stream's own frames, ``(x + 4) / 4``).
* ``encode``: the audio encoder over one 3000-frame window.
* ``decoder_forward``: the text decoder teacher-forced over a token
  sequence; logits and, on request, the cross-attention weights.
* ``served_logprobs``: the log-probabilities of chosen tokens under
  whisper's decoding rules (suppressed tokens, the blank suppression at
  the first sampled token, the timestamp rules) over teacher-forced
  logits, as bounds where a rule's threshold is a tie.
* ``word_probabilities``: the word-timing pass's word probabilities (the
  mean of each word's tokens' probabilities under the text-vocabulary
  softmax).
"""
import contextlib
import math
from typing import Dict, List, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

SAMPLE_RATE = 16000
N_FFT = 400
HOP_LENGTH = 160
N_SAMPLES = 30 * SAMPLE_RATE
N_FRAMES = N_SAMPLES // HOP_LENGTH
NEG = -1e30


@contextlib.contextmanager
def f32_matmuls():
    """float32 matmuls and convolutions without TF32."""
    saved = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = saved


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def param_specs(d: Dict) -> List[Tuple[str, tuple, str]]:
    """(name, shape, kind) of every tensor of the openai checkpoint layout.
    kind: 'matrix' (fan-in scaled normal), 'bias', 'ln_w', 'ln_b', 'emb'
    (token embedding), 'pos' (learned decoder positions), 'sinusoid'
    (the encoder's fixed positions)."""
    A, T = d["n_audio_state"], d["n_text_state"]
    out = [("encoder.positional_embedding", (d["n_audio_ctx"], A),
            "sinusoid"),
           ("encoder.conv1.weight", (A, d["n_mels"], 3), "matrix"),
           ("encoder.conv1.bias", (A,), "bias"),
           ("encoder.conv2.weight", (A, A, 3), "matrix"),
           ("encoder.conv2.bias", (A,), "bias")]

    def block(prefix, n, cross):
        specs = []
        for att in ("attn", "cross_attn") if cross else ("attn",):
            for p in ("query", "key", "value", "out"):
                specs.append((f"{prefix}.{att}.{p}.weight", (n, n), "matrix"))
                if p != "key":
                    specs.append((f"{prefix}.{att}.{p}.bias", (n,), "bias"))
            specs += [(f"{prefix}.{att}_ln.weight", (n,), "ln_w"),
                      (f"{prefix}.{att}_ln.bias", (n,), "ln_b")]
        specs += [(f"{prefix}.mlp.0.weight", (4 * n, n), "matrix"),
                  (f"{prefix}.mlp.0.bias", (4 * n,), "bias"),
                  (f"{prefix}.mlp.2.weight", (n, 4 * n), "matrix"),
                  (f"{prefix}.mlp.2.bias", (n,), "bias"),
                  (f"{prefix}.mlp_ln.weight", (n,), "ln_w"),
                  (f"{prefix}.mlp_ln.bias", (n,), "ln_b")]
        return specs

    for i in range(d["n_audio_layer"]):
        out += block(f"encoder.blocks.{i}", A, False)
    out += [("encoder.ln_post.weight", (A,), "ln_w"),
            ("encoder.ln_post.bias", (A,), "ln_b"),
            ("decoder.positional_embedding", (d["n_text_ctx"], T), "pos"),
            ("decoder.token_embedding.weight", (d["n_vocab"], T), "emb")]
    for i in range(d["n_text_layer"]):
        out += block(f"decoder.blocks.{i}", T, True)
    out += [("decoder.ln.weight", (T,), "ln_w"),
            ("decoder.ln.bias", (T,), "ln_b")]
    return out


def sinusoids(length: int, channels: int) -> torch.Tensor:
    """Whisper's fixed sinusoidal positions, float32."""
    inc = math.log(10000) / (channels // 2 - 1)
    inv = torch.exp(-inc * torch.arange(channels // 2, dtype=torch.float64))
    t = torch.arange(length, dtype=torch.float64)[:, None] * inv[None, :]
    return torch.cat([torch.sin(t), torch.cos(t)], dim=1).float()


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with a scale per row (its last axis'
    absolute maximum at 448), back in float32."""
    s = x.abs().amax(dim=-1, keepdim=True).clamp_min(1e-30) / 448.0
    return (x / s).to(torch.float8_e4m3fn).float() * s


class Weights:
    """The benchmark's weight tensors, read as float32 on `device`. With
    lowp, every matmul's operands (weights and activations) are rounded
    to float8 e4m3 first: the output check's control, the reference
    computed one precision below bfloat16."""

    def __init__(self, sd: Dict[str, torch.Tensor], device,
                 lowp: bool = False):
        self.sd, self.device, self.lowp = sd, device, lowp

    def __call__(self, name: str) -> torch.Tensor:
        return self.sd[name].to(self.device, torch.float32)

    def mat(self, name: str) -> torch.Tensor:
        """A matmul's weight (rows are output channels)."""
        w = self(name)
        if not self.lowp:
            return w
        return fp8(w.reshape(w.shape[0], -1)).reshape(w.shape)

    def act(self, x: torch.Tensor) -> torch.Tensor:
        """A matmul's activation operand (rounded along its last axis)."""
        return fp8(x) if self.lowp else x


# ---------------------------------------------------------------------------
# log-mel frontend
# ---------------------------------------------------------------------------

def _hz_to_mel(f):
    f = np.asarray(f, np.float64)
    lin = f / (200.0 / 3)
    return np.where(f >= 1000.0, 15.0 + np.log(np.maximum(f, 1e-10) / 1000.0)
                    / (np.log(6.4) / 27.0), lin)


def _mel_to_hz(m):
    m = np.asarray(m, np.float64)
    return np.where(m >= 15.0, 1000.0 * np.exp(np.log(6.4) / 27.0
                                                * (m - 15.0)),
                    m * 200.0 / 3)


def mel_filters(n_mels: int) -> np.ndarray:
    """librosa.filters.mel(sr=16000, n_fft=400, n_mels) with Slaney scale
    and norm, float64 [n_mels, 201]."""
    fft_freqs = np.linspace(0, SAMPLE_RATE / 2, N_FFT // 2 + 1)
    hz = _mel_to_hz(np.linspace(_hz_to_mel(0.0), _hz_to_mel(SAMPLE_RATE / 2),
                                n_mels + 2))
    fdiff = np.diff(hz)
    ramps = hz[:, None] - fft_freqs[None, :]
    weights = np.maximum(0, np.minimum(-ramps[:-2] / fdiff[:-1, None],
                                       ramps[2:] / fdiff[1:, None]))
    return weights * (2.0 / (hz[2:] - hz[:-2]))[:, None]


def log_mel(audio: torch.Tensor, n_mels: int) -> torch.Tensor:
    """One stream [L] float32 -> its whole log-mel [n_mels, frames] as
    whisper's transcribe computes it: the stream followed by 30 s of
    zeros, every frame's STFT, the clamp over all of them."""
    x = F.pad(audio.float(), (0, N_SAMPLES))
    window = torch.hann_window(N_FFT, device=x.device)
    spec = torch.stft(x, N_FFT, HOP_LENGTH, window=window,
                      return_complex=True)
    power = spec[..., :-1].abs() ** 2
    fb = torch.from_numpy(mel_filters(n_mels)).float().to(x.device)
    logm = torch.log10(torch.clamp(fb @ power, min=1e-10))
    logm = torch.maximum(logm, logm.max() - 8.0)
    return (logm + 4.0) / 4.0


# ---------------------------------------------------------------------------
# transformer
# ---------------------------------------------------------------------------

def _ln(x, w, prefix):
    return F.layer_norm(x, (x.shape[-1],), w(f"{prefix}.weight"),
                        w(f"{prefix}.bias"), 1e-5)


def _lin(x, w, prefix, bias=True):
    return F.linear(w.act(x), w.mat(f"{prefix}.weight"),
                    w(f"{prefix}.bias") if bias else None)


def _attention(x, kv, w, prefix, n_head, mask=None, want_weights=False):
    q = _lin(x, w, f"{prefix}.query")
    k = _lin(kv, w, f"{prefix}.key", bias=False)
    v = _lin(kv, w, f"{prefix}.value")
    B, T, D = q.shape
    S = k.shape[1]
    dh = D // n_head
    q = q.view(B, T, n_head, dh).transpose(1, 2)
    k = k.view(B, S, n_head, dh).transpose(1, 2)
    v = v.view(B, S, n_head, dh).transpose(1, 2)
    qk = (w.act(q) @ w.act(k).transpose(-1, -2)) / math.sqrt(dh)
    if mask is not None:
        qk = qk + mask
    p = torch.softmax(qk, dim=-1)
    out = (w.act(p) @ w.act(v.transpose(-1, -2)).transpose(-1, -2)
           ).transpose(1, 2).reshape(B, T, D)
    return _lin(out, w, f"{prefix}.out"), (p if want_weights else None)


def _block(x, w, prefix, n_head, xa=None, mask=None, want_weights=False):
    a, _ = _attention(_ln(x, w, f"{prefix}.attn_ln"),
                      _ln(x, w, f"{prefix}.attn_ln"), w, f"{prefix}.attn",
                      n_head, mask)
    x = x + a
    cw = None
    if xa is not None:
        a, cw = _attention(_ln(x, w, f"{prefix}.cross_attn_ln"), xa, w,
                           f"{prefix}.cross_attn", n_head,
                           want_weights=want_weights)
        x = x + a
    h = F.gelu(_lin(_ln(x, w, f"{prefix}.mlp_ln"), w, f"{prefix}.mlp.0"))
    return x + _lin(h, w, f"{prefix}.mlp.2"), cw


@torch.no_grad()
def encode(w: Weights, d: Dict, mel: torch.Tensor) -> torch.Tensor:
    """mel [B, n_mels, 3000] -> encoder output [B, 1500, n_audio_state]."""
    def act_c(x):   # a convolution's input, rounded along its channels
        return w.act(x.transpose(1, 2)).transpose(1, 2)

    x = F.gelu(F.conv1d(act_c(mel.float()), w.mat("encoder.conv1.weight"),
                        w("encoder.conv1.bias"), padding=1))
    x = F.gelu(F.conv1d(act_c(x), w.mat("encoder.conv2.weight"),
                        w("encoder.conv2.bias"), stride=2, padding=1))
    x = x.transpose(1, 2) + sinusoids(d["n_audio_ctx"],
                                      d["n_audio_state"]).to(x.device)
    for i in range(d["n_audio_layer"]):
        x, _ = _block(x, w, f"encoder.blocks.{i}", d["n_audio_head"])
    return _ln(x, w, "encoder.ln_post")


@torch.no_grad()
def decoder_forward(w: Weights, d: Dict, tokens: torch.Tensor,
                    xa: torch.Tensor, cross_layers: Sequence[int] = ()
                    ) -> Tuple[torch.Tensor, Dict[int, torch.Tensor]]:
    """tokens [B, T] (positions 0..T-1) against xa [B, 1500, D] -> (logits
    [B, T, vocab], {layer: cross-attention weights [B, H, T, 1500]} for
    cross_layers)."""
    T = tokens.shape[1]
    x = w("decoder.token_embedding.weight")[tokens] + \
        w("decoder.positional_embedding")[:T]
    mask = torch.triu(torch.full((T, T), -float("inf"), device=x.device), 1)
    cross = {}
    for i in range(d["n_text_layer"]):
        x, cw = _block(x, w, f"decoder.blocks.{i}", d["n_text_head"],
                       xa=xa.float(), mask=mask,
                       want_weights=i in cross_layers)
        if i in cross_layers:
            cross[i] = cw
    x = _ln(x, w, "decoder.ln")
    return w.act(x) @ w.mat("decoder.token_embedding.weight").T, cross


# ---------------------------------------------------------------------------
# decoding rules
# ---------------------------------------------------------------------------

class Vocab:
    """Whisper's multilingual special-token layout over a byte-level base
    vocabulary (the layout a checkpoint without its BPE file decodes
    with)."""

    NON_SPEECH = list("\"#()*+/:;<=>@[\\]^_`{|}~「」『』") + [
        "<<", ">>", "<<<", ">>>", "--", "---", "-(", "-[", "('", "(\"", "((",
        "))", "(((", ")))", "[[", "]]", "{{", "}}", "♪♪", "♪♪♪", "♩", "♪", "♫",
        "♬", "♭", "♮", "♯"]

    def __init__(self, n_vocab: int):
        n_lang = 100 if n_vocab == 51866 else 99
        self.n_vocab = n_vocab
        self.eot = n_vocab - 1501 - 1 - 1 - 1 - 2 - 2 - n_lang - 1
        self.sot = self.eot + 1
        self.lang_en = self.sot + 1
        self.translate = self.sot + 1 + n_lang
        self.transcribe = self.translate + 1
        self.sot_lm = self.transcribe + 1
        self.sot_prev = self.sot_lm + 1
        self.no_speech = self.sot_prev + 1
        self.no_timestamps = self.no_speech + 1
        self.ts_begin = self.no_timestamps + 1
        self.n_lang = n_lang
        self.sot_sequence = [self.sot, self.lang_en, self.transcribe]

    @staticmethod
    def encode(text: str) -> List[int]:
        return list(text.encode("utf-8"))

    def suppressed(self) -> List[int]:
        """Tokens every step masks: the non-speech symbols that are one
        token, the task, start and language tokens, no-speech and
        no-timestamps."""
        ids = set()
        for s in self.NON_SPEECH:
            for variant in (s, " " + s):
                t = self.encode(variant)
                if len(t) == 1:
                    ids.add(t[0])
        ids |= {self.translate, self.transcribe, self.sot, self.sot_prev,
                self.sot_lm, self.no_speech, self.no_timestamps}
        ids |= set(range(self.sot + 1, self.sot + 1 + self.n_lang))
        return sorted(ids)


def _rule_logprobs(logits: torch.Tensor, chosen: Sequence[int],
                   vocab: Vocab, tie: float, max_initial_ts: float):
    """Whisper's rules over logits [N, V] whose row n chose chosen[n]:
    (log-probabilities [N, V] with every text token free, the same with
    the text suppressed, which of the two the forced-timestamp rule
    picks [N], and whether its two sides lie within `tie` nats [N])."""
    N, V = logits.shape
    dev = logits.device
    lg = logits.float().clone()
    lg[:, vocab.suppressed()] = NEG
    lg[0, vocab.encode(" ") + [vocab.eot]] = NEG
    ids = torch.arange(V, device=dev)
    is_ts = ids >= vocab.ts_begin
    # the rules' state before each row, from the tokens chosen
    prev, prev2, last, any_ts = False, False, vocab.ts_begin, False
    states = []
    for t in chosen:
        states.append((prev, prev2, last, any_ts))
        ts = int(t) >= vocab.ts_begin
        prev2, prev = prev, ts
        if ts:
            last, any_ts = int(t), True
    st = torch.tensor([[a, b, c, e] for a, b, c, e in states],
                      dtype=torch.long, device=dev)
    prev_t, prev2_t = st[:, 0].bool(), st[:, 1].bool()
    last_t, any_t = st[:, 2], st[:, 3].bool()
    only_text = prev_t & prev2_t
    open_pair = prev_t & ~prev2_t
    lg = lg.masked_fill(only_text[:, None] & is_ts[None], NEG)
    lg = lg.masked_fill(open_pair[:, None] & (ids < vocab.eot)[None], NEG)
    floor = torch.where(open_pair, last_t, last_t + 1)
    lg = lg.masked_fill(any_t[:, None] & is_ts[None]
                        & (ids[None] < floor[:, None]), NEG)
    bad_first = ~is_ts | (ids > vocab.ts_begin + int(max_initial_ts / 0.02))
    lg[0] = lg[0].masked_fill(bad_first, NEG)
    lp = torch.log_softmax(lg, dim=-1)
    ts_mass = torch.logsumexp(lp.masked_fill(~is_ts[None], NEG), dim=-1)
    text_best = lp.masked_fill(is_ts[None], NEG).amax(dim=-1)
    forced_lp = torch.log_softmax(lg.masked_fill(~is_ts[None], NEG), dim=-1)
    return lp, forced_lp, ts_mass > text_best, \
        (ts_mass - text_best).abs() <= tie


def served_logprobs(logits: torch.Tensor, chosen: Sequence[int],
                    vocab: Vocab, tie: float, max_initial_ts: float = 1.0
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """logits [N, V]: row n the logits that chose chosen[n], the first row
    at the first sampled position. Returns the lowest and highest
    log-probability [N] of each chosen token under whisper's rules:
    suppressed tokens; blank and EOT at the first position; after a
    timestamp pair only text, after a lone timestamp only timestamps;
    timestamps never fall; the first token a timestamp at most
    max_initial_ts; and every text token suppressed where the
    timestamps' total log-probability beats the best text token's. That
    last rule is a threshold on the logits: where the two sides lie
    within `tie` nats, either decision is rounding's, and the bounds span
    both."""
    lp, forced_lp, forced, near = _rule_logprobs(logits, chosen, vocab, tie,
                                                 max_initial_ts)
    tok = torch.as_tensor(list(chosen), device=lp.device)[:, None]
    free, forced_tok = lp.gather(1, tok)[:, 0], forced_lp.gather(1, tok)[:, 0]
    decided = torch.where(forced, forced_tok, free)
    return (torch.where(near, torch.minimum(free, forced_tok), decided),
            torch.where(near, torch.maximum(free, forced_tok), decided))


def rank_gaps(logits: torch.Tensor, chosen: Sequence[int], vocab: Vocab,
              tie: float, beams: int, judged: Sequence[int] = None,
              max_initial_ts: float = 1.0) -> torch.Tensor:
    """How far (nats, >= 0) each judged token (by default the chosen one)
    lies below the `beams`-th best token of its row under whisper's rules,
    their state from the chosen tokens (served_logprobs): 0 where it is
    among the row's `beams` best, as every token of a beam search's
    hypotheses is for its prefix. Where the forced-timestamp rule is
    within `tie` nats, the smaller of its two decisions' gaps. -> [N]"""
    lp, forced_lp, forced, near = _rule_logprobs(logits, chosen, vocab, tie,
                                                 max_initial_ts)
    tok = torch.as_tensor(list(chosen if judged is None else judged),
                          device=lp.device)[:, None]

    def gap(m):
        kth = torch.topk(m, beams, dim=-1).values[:, -1]
        return (kth - m.gather(1, tok)[:, 0]).clamp_min(0.0)

    free, forced_gap = gap(lp), gap(forced_lp)
    decided = torch.where(forced, forced_gap, free)
    return torch.where(near, torch.minimum(free, forced_gap), decided)


def ranked_tokens(logits: torch.Tensor, chosen: Sequence[int],
                  vocab: Vocab, rank: int, max_initial_ts: float = 1.0
                  ) -> List[int]:
    """The token each row of logits [N, V] ranks `rank`-th (from 1) under
    whisper's rules, their state from the chosen tokens, as the
    forced-timestamp rule decides for these logits."""
    lp, forced_lp, forced, _ = _rule_logprobs(logits, chosen, vocab, 0.0,
                                              max_initial_ts)
    m = torch.where(forced[:, None], forced_lp, lp)
    return torch.topk(m, rank, dim=-1).indices[:, -1].tolist()


# ---------------------------------------------------------------------------
# word timing
# ---------------------------------------------------------------------------

def word_probabilities(logits: torch.Tensor, text_tokens: Sequence[int],
                       word_lengths: Sequence[int], vocab: Vocab
                       ) -> np.ndarray:
    """logits [T, V] of the alignment sequence (the start sequence, the
    no-timestamps token, the text tokens, EOT) -> each word's mean
    probability of its tokens under the text-vocabulary softmax."""
    start = len(vocab.sot_sequence)
    probs = torch.softmax(logits[:, :vocab.eot].double(), dim=-1)
    n = len(text_tokens)
    rows = probs[start:start + n]
    p = rows[torch.arange(n), torch.as_tensor(list(text_tokens))]
    p = p.cpu().numpy()
    out, pos = [], 0
    for k in word_lengths:
        out.append(float(p[pos:pos + k].mean()))
        pos += k
    return np.asarray(out)
