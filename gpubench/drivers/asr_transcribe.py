"""Driver of long-form ASR: ``WhisperTranscriber.transcribe_batch`` of the
port, as ``asr_batch_prepass`` calls it, one call a batch of streams.

Set-up makes the weights on the device from the seed (openai checkpoint
layout, one normal draw for all of them), loads them into the port's
``WhisperModel`` in the served dtype, builds one transcriber with the
configured options and runs one warm call, which captures every decode
key. The window repeats calls on fresh draws of the traffic.

The decode is held to a fixed amount of work: ``FixedStepDecoder`` runs the
port's beam loop for exactly p['decode_steps'] steps a window, over the
caches, buffers and graphs that the configured ``max_new_tokens`` sizes
(its EOT is pointed at a token every step suppresses, so no row finishes
early), and hands the transcriber one fixed token template per window.
Every seek then advances a whole window, the word-timing pass aligns the
template's words, and no temperature rung runs. The loop's real tokens and
scores are kept for the output check.

A traffic key named as a transcriber option overrides the configuration's
value for the cell: p['hallucination_silence_threshold'] null runs the
cell without the hallucination-silence rule, whose seek moves follow the
word alignment (seeded weights make every word an anomaly to it).

The check (``check``): for a sample of the windows decoded, drawn from the
seed and holding each stream's last window, the plain float32 reference
(gpubench/reference/whisper.py) computes the window's log-mel, encoder
output and the decoder's logits over the prompt and the served tokens, and
whisper's decoding rules over them:

* ``score_err``: the widest gap between a window's served average
  log-probability (the beam's score of its best hypothesis) and the
  reference's for the same tokens under the same rules (where the forced
  timestamp rule's two sides lie within p['rule_tie_nats'], the reference
  takes either decision: the gap is to the nearer);
* ``rank_gap``: the widest gap (nats) by which a token of a served
  hypothesis lies below the beam_size-th best token of its prefix under
  the same rules (every token a beam search keeps is among its prefix's
  beam_size best; near-ties of the forced timestamp rule as above);
* ``word_prob_err``: the widest |log ratio| of a word's probability in the
  served word timings to the reference's alignment pass;
* ``plan_err``: decode calls, steps, prompts or rungs that differ from the
  plan (0).
"""
import contextlib
import gc
from typing import Dict, List

import numpy as np
import torch

from gpubench import traffic as tg
from gpubench.counts import whisper as counts
from gpubench.harness import Check
from gpubench.reference import whisper as ref

DIM_KEYS = ("n_mels", "n_audio_ctx", "n_audio_state", "n_audio_head",
            "n_audio_layer", "n_vocab", "n_text_ctx", "n_text_state",
            "n_text_head", "n_text_layer")
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
LETTERS = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ"


def dims(cfg: Dict) -> Dict:
    return {k: int(cfg[k]) for k in DIM_KEYS}


def make_weights(d: Dict, seed: int, device, dtype) -> Dict[str, torch.Tensor]:
    """The model's tensors in the openai layout, drawn on `device` in
    `dtype` from one normal draw: matrices normal(0, fan_in^-1/2), biases
    normal(0, 0.02), layer norms 1 + normal(0, 0.05) and normal(0, 0.02),
    the token embedding normal(0, 0.02), the decoder's positions
    normal(0, 0.01); the encoder's positions are whisper's sinusoids."""
    specs = ref.param_specs(d)
    drawn = [(n, s, k) for n, s, k in specs if k != "sinusoid"]
    total = sum(int(np.prod(s)) for _, s, _ in drawn)
    g = torch.Generator(device=device).manual_seed(
        tg.sub_seed(seed, "weights"))
    flat = torch.randn(total, generator=g, device=device, dtype=dtype)
    sd, off = {}, 0
    for name, shape, kind in specs:
        if kind == "sinusoid":
            sd[name] = ref.sinusoids(*shape).to(device, dtype)
            continue
        n = int(np.prod(shape))
        t = flat[off:off + n].view(shape)
        off += n
        if kind == "matrix":
            t.mul_(float(np.prod(shape[1:])) ** -0.5)
        elif kind in ("bias", "ln_b", "emb"):
            t.mul_(0.02)
        elif kind == "ln_w":
            t.mul_(0.05).add_(1.0)
        elif kind == "pos":
            t.mul_(0.01)
        sd[name] = t
    return sd


def template(vocab: ref.Vocab, p: Dict, seed: int):
    """(tokens, text tokens, word lengths in tokens) of the fixed window
    result: two timestamped segments (0.00-14.00 s and 14.00-29.50 s, the
    last timestamp alone, so the whole window is consumed), p['words']
    words whose lengths cycle through p['word_letters'], letters drawn once
    from the seed."""
    rng = np.random.default_rng(tg.sub_seed(seed, "template"))
    lens = [p["word_letters"][i % len(p["word_letters"])]
            for i in range(p["words"])]
    words = [" " + "".join(rng.choice(list(LETTERS), size=n)) for n in lens]
    enc = [vocab.encode(w) for w in words]
    half = len(words) // 2
    ts = vocab.ts_begin
    toks = [ts] + [t for w in enc[:half] for t in w] + [ts + 700, ts + 700] \
        + [t for w in enc[half:] for t in w] + [ts + 1475]
    text = [t for w in enc for t in w]
    return toks, text, [len(w) for w in enc], "".join(words)


class FixedStepDecoder:
    """Stands in the transcriber's beam decoder: the port's beam loop runs
    every window for exactly `steps` steps (its caches, buffers and graph
    keys as its own max_new_tokens sizes them), and the transcriber gets
    the template. Each call's real result is recorded."""

    def __init__(self, inner, tokens: List[int], suppressed_token: int,
                 steps: int):
        self.inner = inner
        inner._eot = suppressed_token     # never chosen: no row finishes
        run_call = inner._run_call

        def fixed_steps(ws, setup, step, max_new, *rest):
            if max_new < steps:
                raise ValueError(f"the decode allows {max_new} steps, "
                                 f"the cell runs {steps}")
            run_call(ws, setup, step, steps, *rest)

        inner._run_call = fixed_steps
        self.tokens = list(tokens)
        self.log: List[Dict] = []

    def decode_prompted(self, xa, prompts, temperature=0.0, generator=None,
                        generators=None):
        if temperature != 0.0:
            raise ValueError("beam search is the temperature-0 rung")
        res = self.inner.decode_prompted(xa, prompts)
        B = xa.shape[0]
        self.log.append(dict(
            prompts=[list(p) if p else [] for p in prompts],
            tokens=[list(map(int, t)) for t in res["tokens"]],
            avg_logprob=np.asarray(res["avg_logprob"], np.float64),
            rows=B))
        return dict(tokens=[list(self.tokens) for _ in range(B)],
                    avg_logprob=np.full(B, -0.3),
                    no_speech_prob=np.zeros(B))

    def decode(self, *a, **k):
        raise RuntimeError("the batched-prompt path decodes with "
                           "decode_prompted only")


class CountingSampler:
    """Stands in the fallback ladder's sampler: counts the rungs run."""

    def __init__(self, inner):
        self.inner, self.calls = inner, 0

    def decode_prompted(self, *a, **k):
        self.calls += 1
        return self.inner.decode_prompted(*a, **k)

    def decode(self, *a, **k):
        self.calls += 1
        return self.inner.decode(*a, **k)


def span_timer():
    """The port's StageTimer whose stages are also profiler spans
    ('stage.<name>'), so a trace names what the host did."""
    from notsofar_tpu_torch.utils.profiling import StageTimer

    class SpanTimer(StageTimer):
        @contextlib.contextmanager
        def stage(self, name: str):
            with torch.profiler.record_function(f"stage.{name}"):
                with super().stage(name):
                    yield

    return SpanTimer()


class Cell:
    def __init__(self, ctx: Dict):
        from notsofar_tpu_torch.asr import decoding
        from notsofar_tpu_torch.asr.tokenizer import load_tokenizer
        from notsofar_tpu_torch.asr.transcribe import (TranscribeOptions,
                                                       WhisperTranscriber)
        from notsofar_tpu_torch.models.whisper import (WhisperDims,
                                                       WhisperModel)
        cfg, p = ctx["config"], ctx["traffic"]
        self.ctx, self.cfg, self.p = ctx, cfg, p
        dev = torch.device(ctx["device"])
        self.d = dims(cfg)
        self.vocab = ref.Vocab(self.d["n_vocab"])
        dtype = DTYPES[cfg["dtype"]]
        self.sd = make_weights(self.d, ctx["seed"], dev, dtype)
        self.model = WhisperModel(WhisperDims(**self.d), dtype=dtype,
                                  device=dev)
        self.model.load_state_dict(self.sd)
        tok = load_tokenizer(cfg["model_name"], self.d["n_vocab"],
                             language=cfg["language"])
        self.template, self.text, self.word_lens, _ = template(
            self.vocab, p["template"], ctx["seed"])
        keys = ("language", "condition_on_previous_text", "word_timestamps",
                "hallucination_silence_threshold", "max_new_tokens",
                "beam_size", "compression_ratio_threshold",
                "logprob_threshold", "no_speech_threshold",
                "max_rows_per_dispatch")
        opts = TranscribeOptions(**{k: p[k] if k in p else cfg[k]
                                    for k in keys})
        self.tr = WhisperTranscriber(self.model, tok, opts)
        self.dec = FixedStepDecoder(self.tr.decoder, self.template,
                                    self.vocab.sot, int(p["decode_steps"]))
        self.tr.decoder = self.dec
        self.sampler = CountingSampler(self.tr._sampler)
        self.tr._sampler = self.sampler
        self.decoding = decoding
        # the traffic: p['draws'] calls' streams, drawn on the device,
        # held in host memory
        self.draws = [tg.streams(p, ctx["seed"], i, dev).cpu().numpy()
                      for i in range(int(p["draws"]))]
        self.call_index = 0
        self.results: List[Dict] = []
        self.timer = span_timer()
        # the warm call: streams of p['warm_seconds'] (two seeks reach
        # every decode key: the bare start sequence and the longest prompt
        # bucket, at every dispatch size)
        warm = self.draws[-1][:, :int(p["warm_seconds"] * tg.SAMPLE_RATE)]
        self.call(warm=warm)

    # -- the work ------------------------------------------------------
    def call(self, warm=None) -> float:
        i = self.call_index
        audios = list(self.draws[i % len(self.draws)] if warm is None
                      else warm)
        start = len(self.dec.log)
        timer = self.timer if warm is None else span_timer()
        out = self.tr.transcribe_batch(audios, timer=timer)
        if warm is not None:
            return 0.0
        self.results.append(dict(draw=i % len(self.draws), out=out,
                                 log=self.dec.log[start:]))
        self.call_index += 1
        return float(len(audios) * self.p["stream_seconds"])

    def start_window(self) -> None:
        self.timer = span_timer()
        self.decoding.reset_decode_steps()
        self.results = []
        self.sampler.calls = 0

    def window_record(self) -> Dict:
        steps = self.decoding.DECODE_STEPS
        return dict(stages=dict(self.timer.stage_seconds),
                    counters=dict(steps), work=self.work(),
                    attempted=len(self.results) * int(self.p["streams"]),
                    check_data=dict(
                        sd=self.sd, results=self.results, d=self.d,
                        sampled_rungs=self.sampler.calls,
                        template=self.template, text=self.text,
                        word_lens=self.word_lens))

    def plan(self) -> Dict:
        """The work one call is planned to do."""
        p, cfg = self.p, self.cfg
        seeks = int(np.ceil(p["stream_seconds"] / 30.0))
        per = max(int(cfg["max_rows_per_dispatch"]) // cfg["beam_size"], 1)
        dispatches = seeks * int(np.ceil(p["streams"] / per))
        return dict(seeks=seeks, dispatches=dispatches,
                    steps=dispatches * int(p["decode_steps"]),
                    windows=seeks * int(p["streams"]), streams_per=per)

    def work(self) -> Dict:
        """Operations and bytes of the window's calls, from the plan."""
        d, cfg, pl = self.d, self.cfg, self.plan()
        K, n = int(cfg["beam_size"]), int(self.p["decode_steps"])
        flops = dict(encode=0.0, decode=0.0, align=0.0)
        dec_bytes = 0.0
        per_call = []
        for r in self.results:
            call_flops = dict(encode=0.0, decode=0.0, align=0.0)
            call_bytes = 0.0
            for entry in r["log"]:
                lens = [len(decode_prompt(self.vocab, d, pr))
                        for pr in entry["prompts"]]
                for c0 in range(0, len(lens), pl["streams_per"]):
                    chunk = lens[c0:c0 + pl["streams_per"]]
                    call_flops["decode"] += counts.decode_setup_flops(
                        d, chunk) + sum(counts.decode_step_flops(
                            d, chunk, K, s) for s in range(n))
                    call_bytes += counts.decode_call_bytes(d, chunk, K, n)
                call_flops["encode"] += entry["rows"] * counts.encoder_flops(d)
                call_flops["align"] += entry["rows"] * counts.alignment_flops(
                    d, len(self.text) + 5, self.vocab.eot)
            per_call.append(dict(flops=call_flops, decode_bytes=call_bytes))
            for k in flops:
                flops[k] += call_flops[k]
            dec_bytes += call_bytes
        return dict(flops=flops, decode_bytes=dec_bytes, per_call=per_call,
                    plan=pl, calls=len(self.results),
                    gemv_weight_bytes=counts.decode_step_weight_bytes(d),
                    gemv_launches_per_step=6 * d["n_text_layer"] + 1)

    def release(self) -> None:
        self.tr = self.dec = self.sampler = self.model = None
        self.draws = None
        gc.collect()     # the decoders' workspaces go with them
        self.decoding.WORKSPACES.fit(0)


def setup(ctx: Dict) -> Cell:
    return Cell(ctx)


# ---------------------------------------------------------------------------
# the output check
# ---------------------------------------------------------------------------

def sample_windows(results: List[Dict], p: Dict, seed: int, n: int):
    """(call, seek, stream) of n windows drawn from the seed among those
    decoded, each stream's last seek among them."""
    seeks = int(np.ceil(p["stream_seconds"] / 30.0))
    every = [(c, k, b) for c in range(len(results)) for k in range(seeks)
             for b in range(int(p["streams"]))]
    rng = np.random.default_rng(tg.sub_seed(seed, "check"))
    last = [w for w in every if w[1] == seeks - 1]
    pick = [last[i] for i in rng.choice(len(last), size=min(n // 2,
                                                            len(last)),
                                        replace=False)]
    rest = [w for w in every if w not in pick]
    pick += [rest[i] for i in rng.choice(len(rest), size=min(n - len(pick),
                                                             len(rest)),
                                         replace=False)]
    return sorted(pick)


def decode_prompt(vocab: ref.Vocab, d: Dict, previous: List[int]
                  ) -> List[int]:
    """A decode's real prompt: the previous text's last n_text_ctx/2 - 1
    tokens after the previous-text token, then the start sequence."""
    pre = [vocab.sot_prev] + list(previous)[-(d["n_text_ctx"] // 2 - 1):] \
        if previous else []
    return pre + vocab.sot_sequence


def expected_prompt(tmpl: List[int], seek: int) -> List[int]:
    """The previous text the transcriber passes at `seek`: the template of
    every earlier window (all of it kept: whole windows, no segment
    emptied)."""
    return list(tmpl) * seek


def reference_readings(ctx: Dict, record: Dict,
                       control: bool = False) -> Dict:
    """The check's numbers for the sampled windows: the served numbers
    against the float32 reference's, or with control=True the reference
    computed in float8 (reference.whisper.Weights(lowp=True)) in the
    served numbers' place, over the same prompts and tokens. The
    control's rank_gap judges the token it ranks beam_size-th at each
    position, the weakest that its beam search would keep
    (rank_gap_first: the one it ranks first, which reads 0 on half the
    seeds: PERF.md)."""
    data, cfg, p = record["check_data"], ctx["config"], ctx["traffic"]
    dev = torch.device(ctx["device"])
    d = data["d"]
    vocab = ref.Vocab(d["n_vocab"])
    w = ref.Weights(data["sd"], dev)
    wc = ref.Weights(data["sd"], dev, lowp=True) if control else None
    K = int(cfg["beam_size"])
    n = int(p["decode_steps"])
    per = max(int(cfg["max_rows_per_dispatch"]) // K, 1)
    results = data["results"]
    plan_err = int(data["sampled_rungs"])
    seeks = int(np.ceil(p["stream_seconds"] / 30.0))
    for r in results:
        plan_err += abs(len(r["log"]) - seeks)
        for k, e in enumerate(r["log"]):
            want = expected_prompt(data["template"], k)
            plan_err += sum(pr != want for pr in e["prompts"])
            plan_err += sum(len(t) != n for t in e["tokens"])
    counters = record["counters"]
    planned_steps = len(results) * seeks * int(np.ceil(p["streams"] / per)) \
        * n
    plan_err += abs(int(counters["eager"] + counters["replayed"])
                    - planned_steps)
    score, wprob, rank, rank_first = 0.0, 0.0, 0.0, 0.0
    tie = float(p["rule_tie_nats"])
    windows = sample_windows(results, p, ctx["seed"],
                             int(p["check_windows"]))
    align = vocab.sot_sequence + [vocab.no_timestamps] + data["text"] + \
        [vocab.eot]
    with ref.f32_matmuls():
        for c, k, b in windows:
            r = results[c]
            e = r["log"][k]
            audio = tg.streams(p, ctx["seed"], r["draw"], dev)[b]
            mel = ref.log_mel(audio, d["n_mels"])
            window = mel[None, :, k * ref.N_FRAMES:(k + 1) * ref.N_FRAMES]
            prompt = decode_prompt(vocab, d,
                                   expected_prompt(data["template"], k))
            served = e["tokens"][b]
            seq = torch.tensor(prompt + served, device=dev)[None]
            want = _window_numbers(w, d, vocab, window, seq, prompt, served,
                                   align, data, n, tie)
            gap = lambda judged: float(ref.rank_gaps(  # noqa: E731
                want["rows"], served, vocab, tie, K, judged).max())
            if control:
                got = _window_numbers(wc, d, vocab, window, seq, prompt,
                                      served, align, data, n, 0.0)
                got["avg"] = got["avg"][0]
                rank = max(rank, gap(ref.ranked_tokens(got["rows"], served,
                                                       vocab, K)))
                rank_first = max(rank_first, gap(ref.ranked_tokens(
                    got["rows"], served, vocab, 1)))
            else:
                rank = max(rank, gap(served))
                words = [x for s in r["out"][b]["segments"]
                         for x in s["words"]]
                nw = len(data["word_lens"])
                words = words[k * nw:(k + 1) * nw]
                got = dict(
                    avg=float(e["avg_logprob"][b]),
                    log_wp=np.log(np.maximum(np.asarray(
                        [x["probability"] for x in words], np.float64),
                        1e-300)) if len(words) == nw else None)
            lo, hi = want["avg"]
            score = max(score, lo - got["avg"], got["avg"] - hi)
            if cfg["word_timestamps"]:
                wprob = max(wprob, float("inf") if got["log_wp"] is None
                            else float(np.max(np.abs(got["log_wp"]
                                                     - want["log_wp"]))))
    out = dict(score_err=score, rank_gap=rank, word_prob_err=wprob,
               plan_err=float(plan_err))
    if control:
        out["rank_gap_first"] = rank_first
    return out


def _window_numbers(w, d, vocab, window, seq, prompt, served, align, data,
                    n, tie) -> Dict:
    """One window's served numbers as the reference (weights `w`) computes
    them: the served tokens' average log-probability under whisper's rules
    (lowest and highest, see reference.whisper.served_logprobs), the
    logits that chose them and the word timing pass's log word
    probabilities."""
    dev = seq.device
    xa = ref.encode(w, d, window)
    logits, _ = ref.decoder_forward(w, d, seq, xa)
    rows = logits[0, len(prompt) - 1:len(prompt) - 1 + len(served)]
    low, high = ref.served_logprobs(rows, served, vocab, tie)
    al, _ = ref.decoder_forward(w, d, torch.tensor(align, device=dev)[None],
                                xa)
    wp = ref.word_probabilities(al[0], data["text"], data["word_lens"], vocab)
    return dict(avg=(float(low.sum()) / (n + 1), float(high.sum()) / (n + 1)),
                rows=rows, log_wp=np.log(wp))


def judge(ctx: Dict, readings: Dict) -> List[Check]:
    """The readings held to the traffic's limits."""
    lim = ctx["traffic"]["limits"]
    return [Check(k, readings[k], float(lim[k])) for k in
            ("score_err", "rank_gap", "word_prob_err", "plan_err")]


def check(ctx: Dict, record: Dict) -> List[Check]:
    return judge(ctx, reference_readings(ctx, record))


# ---------------------------------------------------------------------------
# the control
# ---------------------------------------------------------------------------

def control_readings(ctx: Dict, record: Dict) -> Dict:
    """The check's numbers of the control: the reference computed in
    float8 e4m3 (every matmul's operands rounded) in the program's place.
    (The port's int8 path stores the decoder's weights in int8 but computes
    in bfloat16: it reads within the program's own spread.)"""
    return reference_readings(ctx, record, control=True)
