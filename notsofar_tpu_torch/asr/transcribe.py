"""Long-form transcription: the 30-second seek loop over session streams.

Port of notsofar_tpu/asr/transcribe.py, which rebuilds the
openai-whisper transcribe() behaviour (word_timestamps=True,
beam_size=5, hallucination_silence_threshold=2.0):

* timestamp-token-driven segmentation and seek advancement, including
  the single_timestamp_ending rule,
* word-timestamp-based seek refinement (jump to the last aligned word
  end),
* hallucination_silence_threshold: skip silence gaps around suspected
  hallucinations using per-word anomaly scores,
* condition_on_previous_text (sot_prev prompt), with whisper's
  temperature > 0.5 prompt-reset rule,
* no-speech skipping (no_speech_prob > 0.6 unless avg_logprob > -1.0),
* word-level timestamps via teacher-forced cross-attention DTW, with
  whisper's median-duration truncation hacks and token-count-based
  word-to-segment distribution,
* beam search (asr/beam.py) with whisper's temperature-fallback ladder:
  retries with gumbel sampling at 0.2..1.0 when the hypothesis compresses
  suspiciously well (repetition) or scores below the logprob threshold.

The seek/segmentation rules are the same pure functions as in the JAX
package (parse_segments, add_word_timestamps, apply_seek_rules).

Sampling: the JAX package draws with per-row threefry keys
fold_in(fold_in(42, seek), rung); those bits cannot be reproduced here.
The contract is kept instead: each row draws from its own
torch.Generator seeded from (seek, rung), so a row samples as a B=1
decode with the same (seek, rung) would, whatever the batch.
"""
import contextlib
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch

from notsofar_tpu_torch.asr.decoding import (DecodeOptions, GreedyDecoder,
                                             detect_language,
                                             find_word_timestamps,
                                             find_word_timestamps_batch,
                                             merge_punctuations)
from notsofar_tpu_torch.asr.mel import (HOP_LENGTH, N_FRAMES, N_SAMPLES,
                                        SAMPLE_RATE,
                                        log_mel_spectrogram_batch)
from notsofar_tpu_torch.asr.tokenizer import WhisperTokenizer
from notsofar_tpu_torch.models.whisper import WhisperModel
from notsofar_tpu_torch.utils.logging_def import get_logger
from notsofar_tpu_torch.utils.profiling import StageTimer

_LOG = get_logger("transcribe")

FRAMES_PER_SECOND = SAMPLE_RATE // HOP_LENGTH  # 100
INPUT_STRIDE = 2                                # mel frames per output token
TIME_PRECISION = INPUT_STRIDE / FRAMES_PER_SECOND  # 0.02 s

# whisper transcribe.py `punctuation` (prepend + append, concatenated) —
# membership test is substring-in-string, matching whisper
_PUNCTUATION = "\"'“¿([{-\"'.。,，!！?？:：”)]}、"
_SENTENCE_END_MARKS = ".。!！?？"

FALLBACK_SEED = 42   # base of the fallback ladder's per-(seek, rung) seeds


@dataclass
class TranscribeOptions:
    language: Optional[str] = "en"  # None -> detect on the first window
    condition_on_previous_text: bool = True
    no_speech_threshold: float = 0.6
    logprob_threshold: float = -1.0
    compression_ratio_threshold: Optional[float] = 2.4
    temperatures: tuple = (0.0, 0.2, 0.4, 0.6, 0.8, 1.0)
    word_timestamps: bool = True
    hallucination_silence_threshold: Optional[float] = 2.0
    max_new_tokens: int = 224
    beam_size: Optional[int] = None  # None/1 = greedy; 5 in the shipped cfg
    # per-model cross-attention head selection for word-timestamp DTW
    # ((layer, head) pairs; see decoding.decode_alignment_heads). None ->
    # whisper's fallback of all heads in the last half of the layers.
    alignment_heads: Optional[list] = None
    # decode all active streams in ONE loop per iteration; requires
    # condition_on_previous_text=False (identical prompts across the batch)
    lockstep_decode: bool = False
    # batch per-row prompts (condition_on_previous_text) into one decode
    # per iteration via right-aligned prompt buckets. False = per-stream
    # serial decodes.
    batched_prompts: bool = True
    # rows per decode call (None = DecodeOptions default 12)
    max_rows_per_dispatch: Optional[int] = None


def compression_ratio(text: str) -> float:
    """zlib compressibility of the text — whisper's repetition detector."""
    import zlib
    data = text.encode("utf-8")
    if not data:
        return 0.0
    return len(data) / len(zlib.compress(data))


def fallback_generator(seek: int, rung: int,
                       device: torch.device) -> torch.Generator:
    """The sampling generator of one fallback-ladder rung of the window at
    ``seek`` (a pure function of (seek, rung), so batched and serial
    transcription draw the same numbers)."""
    seed = (FALLBACK_SEED * 1_000_003 + int(seek)) * 1_000_003 + int(rung)
    return torch.Generator(device=device).manual_seed(seed)


# ===========================================================================
# Pure whisper control-flow ports (unit-tested without a model)
# ===========================================================================

def parse_segments(tokens: List[int], timestamp_begin: int,
                   time_offset: float, segment_size: int, decode_text):
    """Whisper's timestamp segmentation + seek rule (transcribe.py).

    tokens: sampled tokens for one window (sot/prompt/eot stripped).
    decode_text: fn(text_tokens)->str.
    Returns (segments, seek_increment_frames, single_timestamp_ending).

    * consecutive timestamp pairs delimit segments; with a single
      timestamp at the very end, the trailing slice is closed at
      len(tokens) and the WHOLE window is consumed,
    * otherwise the unfinished trailing segment is dropped and seek
      advances to the last consecutive-pair timestamp,
    * with no consecutive pairs, the whole window forms one segment whose
      duration comes from the last nonzero timestamp (else the window
      length), and the whole window is consumed.
    """
    ts = timestamp_begin
    is_ts = [t >= ts for t in tokens]
    single_timestamp_ending = (len(tokens) >= 2 and is_ts[-1]
                               and not is_ts[-2])

    def new_segment(start, end, sliced):
        text_tokens = [t for t in sliced if t < ts]
        return dict(start=start, end=end, text=decode_text(text_tokens),
                    tokens=list(sliced), words=[])

    segments: List[Dict] = []
    consecutive = [i + 1 for i in range(len(tokens) - 1)
                   if is_ts[i] and is_ts[i + 1]]
    if consecutive:
        slices = list(consecutive)
        if single_timestamp_ending:
            slices.append(len(tokens))
        last_slice = 0
        for current_slice in slices:
            sliced = tokens[last_slice:current_slice]
            start_pos = sliced[0] - ts
            end_pos = sliced[-1] - ts
            segments.append(new_segment(
                time_offset + start_pos * TIME_PRECISION,
                time_offset + end_pos * TIME_PRECISION, sliced))
            last_slice = current_slice
        if single_timestamp_ending:
            seek_inc = segment_size
        else:
            seek_inc = (tokens[last_slice - 1] - ts) * INPUT_STRIDE
    else:
        duration = segment_size * HOP_LENGTH / SAMPLE_RATE
        timestamps = [t for t in tokens if t >= ts]
        if timestamps and timestamps[-1] != ts:
            duration = (timestamps[-1] - ts) * TIME_PRECISION
        segments.append(new_segment(time_offset, time_offset + duration,
                                    tokens))
        seek_inc = segment_size
    # whisper assumes monotonic timestamps keep seek advancing; clamp to 1
    # frame so a degenerate decode can never stall the loop
    return segments, max(int(seek_inc), 1), single_timestamp_ending


def add_word_timestamps(segments: List[Dict], alignment: List[Dict],
                        time_offset: float, last_speech_timestamp: float,
                        eot: int) -> None:
    """Whisper timing.add_word_timestamps: duration hacks + distribution.

    alignment: raw word list (find_word_timestamps(merge=False)) with
    WINDOW-RELATIVE times and per-word 'probability'/'n_tokens'. Mutates
    segments in place: fills 'words' (absolute times, rounded to 2 dp) and
    adjusts segment start/end to the aligned word extents.
    """
    if not segments:
        return
    alignment = [dict(w) for w in alignment]
    word_durations = [w["end"] - w["start"] for w in alignment
                      if w["end"] - w["start"] > 0]
    median_duration = float(np.median(word_durations)) \
        if word_durations else 0.0
    median_duration = min(0.7, median_duration)
    max_duration = median_duration * 2

    # hack: truncate long words at sentence boundaries (timing.py)
    if word_durations:
        for i in range(1, len(alignment)):
            if alignment[i]["end"] - alignment[i]["start"] > max_duration:
                if alignment[i]["word"] in _SENTENCE_END_MARKS:
                    alignment[i]["end"] = \
                        alignment[i]["start"] + max_duration
                elif alignment[i - 1]["word"] in _SENTENCE_END_MARKS:
                    alignment[i]["start"] = \
                        alignment[i]["end"] - max_duration

    alignment = merge_punctuations(alignment)

    word_index = 0
    for segment in segments:
        text_token_count = len([t for t in segment["tokens"] if t < eot])
        saved_tokens = 0
        words: List[Dict] = []
        while word_index < len(alignment) and saved_tokens < text_token_count:
            timing = alignment[word_index]
            if timing["word"]:
                words.append(dict(
                    word=timing["word"],
                    start=round(time_offset + timing["start"], 2),
                    end=round(time_offset + timing["end"], 2),
                    probability=timing.get("probability", 0.0)))
            saved_tokens += timing.get("n_tokens", 1)
            word_index += 1

        if words:
            # hack: ensure the first and second word after a pause are not
            # longer than twice the median word duration (timing.py)
            if words[0]["end"] - last_speech_timestamp > median_duration * 4 \
                    and (words[0]["end"] - words[0]["start"] > max_duration
                         or (len(words) > 1 and
                             words[1]["end"] - words[0]["start"]
                             > max_duration * 2)):
                if len(words) > 1 and \
                        words[1]["end"] - words[1]["start"] > max_duration:
                    boundary = max(words[1]["end"] / 2,
                                   words[1]["end"] - max_duration)
                    words[0]["end"] = words[1]["start"] = boundary
                words[0]["start"] = max(0.0, words[0]["end"] - max_duration)

            # prefer segment-level start/end when the edge word is too long
            if segment["start"] < words[0]["end"] and \
                    segment["start"] - 0.5 > words[0]["start"]:
                words[0]["start"] = max(
                    0.0, min(words[0]["end"] - median_duration,
                             segment["start"]))
            else:
                segment["start"] = words[0]["start"]
            if segment["end"] > words[-1]["start"] and \
                    segment["end"] + 0.5 < words[-1]["end"]:
                words[-1]["end"] = max(words[-1]["start"] + median_duration,
                                       segment["end"])
            else:
                segment["end"] = words[-1]["end"]
        segment["words"] = words


def word_anomaly_score(word: Dict) -> float:
    """Whisper transcribe.py word_anomaly_score."""
    probability = word.get("probability", 0.0)
    duration = word["end"] - word["start"]
    score = 0.0
    if probability < 0.15:
        score += 1.0
    if duration < 0.133:
        score += (0.133 - duration) * 15
    if duration > 2.0:
        score += duration - 2.0
    return score


def is_segment_anomaly(segment: Optional[Dict]) -> bool:
    """Whisper transcribe.py is_segment_anomaly."""
    if segment is None or not segment["words"]:
        return False
    words = [w for w in segment["words"] if w["word"] not in _PUNCTUATION]
    words = words[:8]
    if not words:
        return False
    score = sum(word_anomaly_score(w) for w in words)
    return score >= 3 or score + 0.01 >= len(words)


def next_words_segment(segments: List[Dict]) -> Optional[Dict]:
    return next((s for s in segments if s["words"]), None)


def get_end(segments: List[Dict]) -> Optional[float]:
    return next((w["end"] for s in reversed(segments)
                 for w in reversed(s["words"])), None)


def apply_seek_rules(segments: List[Dict], *, previous_seek: int, seek: int,
                     segment_size: int, time_offset: float,
                     window_end_time: float, content_frames: int,
                     content_duration: float,
                     single_timestamp_ending: bool,
                     threshold: Optional[float],
                     last_speech_timestamp: float):
    """Whisper's word-timestamp seek refinement + hallucination skipping
    (the `if word_timestamps:` block of transcribe.py after
    add_word_timestamps).

    Returns (seek, segments, skip_window). skip_window=True reproduces the
    `continue` on a leading-gap hallucination: the caller must drop ALL of
    this window's segments and tokens.
    """
    if not single_timestamp_ending:
        last_word_end = get_end(segments)
        if last_word_end is not None and last_word_end > time_offset:
            seek = round(last_word_end * FRAMES_PER_SECOND)

    if threshold is not None:
        # if decoding stopped mid-window, either trust the word alignment
        # (enough trailing silence) or fall back to a full-window hop
        if not single_timestamp_ending:
            last_word_end = get_end(segments)
            if last_word_end is not None and last_word_end > time_offset:
                remaining_duration = window_end_time - last_word_end
                if remaining_duration > threshold:
                    seek = round(last_word_end * FRAMES_PER_SECOND)
                else:
                    seek = previous_seek + segment_size

        # if the first segment might be a hallucination, skip leading silence
        first_segment = next_words_segment(segments)
        if first_segment is not None and is_segment_anomaly(first_segment):
            gap = first_segment["start"] - time_offset
            if gap > threshold:
                seek = previous_seek + round(gap * FRAMES_PER_SECOND)
                return seek, segments, True

        # skip silence before any possible hallucination surrounded by
        # silence or more hallucinations
        hal_last_end = last_speech_timestamp
        for si, segment in enumerate(segments):
            if not segment["words"]:
                continue
            if is_segment_anomaly(segment):
                next_segment = next_words_segment(segments[si + 1:])
                if next_segment is not None:
                    hal_next_start = next_segment["words"][0]["start"]
                else:
                    hal_next_start = time_offset + \
                        segment_size * HOP_LENGTH / SAMPLE_RATE
                silence_before = (
                    segment["start"] - hal_last_end > threshold
                    or segment["start"] < threshold
                    or segment["start"] - time_offset < 2.0)
                silence_after = (
                    hal_next_start - segment["end"] > threshold
                    or is_segment_anomaly(next_segment)
                    or window_end_time - segment["end"] < 2.0)
                if silence_before and silence_after:
                    seek = round(max(time_offset + 1, segment["start"])
                                 * FRAMES_PER_SECOND)
                    if content_duration - segment["end"] < threshold:
                        seek = content_frames
                    segments = segments[:si]
                    break
            hal_last_end = segment["end"]
    return seek, segments, False


# ===========================================================================
# Transcriber
# ===========================================================================

@dataclass
class _Stream:
    """Per-stream long-form decode state."""
    content_frames: int
    seek: int = 0
    all_tokens: List[int] = field(default_factory=list)
    prompt_reset_since: int = 0
    segments: List[Dict] = field(default_factory=list)
    last_speech_timestamp: float = 0.0


class WhisperTranscriber:
    def __init__(self, model: WhisperModel, tokenizer: WhisperTokenizer,
                 options: TranscribeOptions = TranscribeOptions()):
        self.model = model
        self.tok = tokenizer
        self.opt = options
        extra = {}
        if options.max_rows_per_dispatch is not None:
            extra["max_rows_per_dispatch"] = options.max_rows_per_dispatch
        dec_opts = DecodeOptions(language=options.language,
                                 max_new_tokens=options.max_new_tokens,
                                 **extra)
        if options.beam_size and options.beam_size > 1:
            from notsofar_tpu_torch.asr.beam import BeamDecoder
            self.decoder = BeamDecoder(model, tokenizer, dec_opts,
                                       beam_size=options.beam_size)
            # the fallback ladder samples without a beam (whisper behavior)
            self._sampler = GreedyDecoder(model, tokenizer, dec_opts)
        else:
            self.decoder = GreedyDecoder(model, tokenizer, dec_opts)
            self._sampler = self.decoder
        self._language_detected = options.language is not None
        self.last_phase_timer: Optional[StageTimer] = None

    def _maybe_detect_language(self, xa_one):
        """When TranscribeOptions.language is None, identify the language on
        the first encoded window and rebuild the sot sequence."""
        if self._language_detected:
            return
        code = detect_language(self.model, self.tok, xa_one)[0]
        _LOG.info(f"detected language: {code}")
        self.tok.language = code
        self.tok.sot_sequence = self.tok.specials.sot_sequence(code,
                                                               self.tok.task)
        self._language_detected = True

    def _needs_fallback(self, tokens, avg_logprob: float,
                        no_speech_prob: float) -> bool:
        """whisper's temperature-fallback gates: too compressible
        (repetition) or too low a logprob, unless the window is silence."""
        opt = self.opt
        needs = False
        if opt.compression_ratio_threshold is not None and \
                compression_ratio(self.tok.decode(tokens)) > \
                opt.compression_ratio_threshold:
            needs = True
        if opt.logprob_threshold is not None and \
                avg_logprob < opt.logprob_threshold:
            needs = True
        if opt.no_speech_threshold is not None and \
                no_speech_prob > opt.no_speech_threshold:
            needs = False   # silence — don't fight it
        return needs

    def _decode_with_fallback(self, xa, prompt, salt: int = 0):
        """whisper's temperature ladder for one window: retry at increasing
        temperatures while the hypothesis fails the fallback gates. The
        sampling generator is a pure function of (salt, rung).
        Returns (result, temperature_used)."""
        result, t = None, 0.0
        for ti, t in enumerate(self.opt.temperatures):
            if t == 0.0:
                result = self.decoder.decode(xa, prompt)
            else:
                result = self._sampler.decode(
                    xa, prompt, temperature=t,
                    generator=fallback_generator(salt, ti, xa.device))
            if not self._needs_fallback(result["tokens"][0],
                                        float(result["avg_logprob"][0]),
                                        float(result["no_speech_prob"][0])):
                break
        return result, t

    def _decode_batch_with_fallback(self, xa, streams):
        """Batched temperature ladder over active streams with per-row
        prompts (decode_prompted): rung 0 decodes every row in one loop;
        each following rung re-decodes ONLY the rows whose hypotheses
        failed whisper's compression/logprob gates. Returns (results,
        temperatures) aligned with `streams`. Row j of rung ti samples
        from fallback_generator(streams[j].seek, ti), as the serial path's
        salt=seek does for a B=1 decode."""
        n = xa.shape[0]
        prompts = [s.all_tokens[s.prompt_reset_since:]
                   if self.opt.condition_on_previous_text else None
                   for s in streams]
        results: List[Optional[Dict]] = [None] * n
        temps = [0.0] * n
        todo = list(range(n))
        for ti, t in enumerate(self.opt.temperatures):
            xa_sub = xa[todo] if len(todo) != n else xa
            sub_prompts = [prompts[j] for j in todo]
            if t == 0.0:
                res = self.decoder.decode_prompted(xa_sub, sub_prompts)
            else:
                gens = [fallback_generator(streams[j].seek, ti, xa.device)
                        for j in todo]
                res = self._sampler.decode_prompted(
                    xa_sub, sub_prompts, temperature=t, generators=gens)
            still = []
            for r, j in enumerate(todo):
                results[j] = dict(
                    tokens=[res["tokens"][r]],
                    avg_logprob=res["avg_logprob"][r:r + 1],
                    no_speech_prob=res["no_speech_prob"][r:r + 1])
                temps[j] = t
                if self._needs_fallback(res["tokens"][r],
                                        float(res["avg_logprob"][r]),
                                        float(res["no_speech_prob"][r])):
                    still.append(j)
            todo = still
            if not todo:
                break
        return results, temps

    # ------------------------------------------------------------------
    def transcribe(self, audio: np.ndarray, sr: int = SAMPLE_RATE) -> Dict:
        """audio: mono float waveform. Returns {'segments': [...], 'text'}
        with the whisper result structure (start/end/text/words per
        segment; words have word/start/end/probability)."""
        return self.transcribe_batch([audio], sr)[0]

    # ------------------------------------------------------------------
    @torch.no_grad()
    def transcribe_batch(self, audios: List, sr: int = SAMPLE_RATE,
                         timer: Optional[StageTimer] = None) -> List[Dict]:
        """Transcribe several streams with lockstep-batched windows: the
        active streams' current 30 s windows are encoded and decoded as
        one batch per iteration, with per-stream seek state advancing
        independently. Word-timestamp extraction also batches.

        audios: numpy arrays or tensors (a tensor already on the model's
        device is used in place). timer: accumulates the seconds of the
        mel/encode/decode/word_ts stages (a new one by default); kept as
        last_phase_timer."""
        if sr != SAMPLE_RATE:
            raise ValueError("resample to 16 kHz before ASR")
        B = len(audios)
        if B == 0:
            return []
        dev = self.model.device
        if timer is None:
            timer = StageTimer()
        self.last_phase_timer = timer
        streams: List[_Stream] = []
        with timer.stage("mel"):
            # one batched call for all streams, rows padded to 30 s
            # multiples; the mels stay on the device and windows are sliced
            # there per iteration (encode_windows). Each row's
            # dynamic-range clamp maxes over only its valid frames, so rows
            # equal per-stream calls.
            lens = [int(a.numel() if torch.is_tensor(a) else a.size)
                    for a in audios]
            L_max = max(lens) + N_SAMPLES
            L_max = int(np.ceil(L_max / N_SAMPLES) * N_SAMPLES)
            batch = torch.zeros((B, L_max), dtype=torch.float32, device=dev)
            for b, a in enumerate(audios):
                row = a if torch.is_tensor(a) else torch.from_numpy(
                    np.asarray(a, np.float32))
                batch[b, :lens[b]] = row.reshape(-1).to(dev, torch.float32)
            valid = np.asarray(
                [(n + N_SAMPLES) // HOP_LENGTH for n in lens], np.int64)
            mels = log_mel_spectrogram_batch(
                batch, torch.from_numpy(valid).to(dev),
                n_mels=self.model.dims.n_mels)
            for b in range(B):
                streams.append(_Stream(
                    content_frames=max(int(valid[b]) - N_FRAMES, 1)))

        while True:
            active = [b for b in range(B)
                      if streams[b].seek < streams[b].content_frames]
            if not active:
                break
            # windows are sliced straight out of the N_SAMPLES-padded mel,
            # so tail windows carry mel-of-silence like whisper's slicing
            seeks = [min(s.seek, s.content_frames) for s in streams]
            with timer.stage("encode"):
                xa_full = self.model.encode_windows(mels, seeks)
            xa = xa_full[active] if len(active) != B else xa_full
            self._maybe_detect_language(xa[0:1])

            if self.opt.lockstep_decode and \
                    not self.opt.condition_on_previous_text:
                # one decode for all active streams (identical prompts); the
                # temperature ladder is per-window and stays on the serial
                # paths
                with timer.stage("decode"):
                    res_all = self.decoder.decode(xa_full, None)
                pending = []
                for b in active:
                    pre = self._pre_align(streams[b], dict(
                        tokens=[res_all["tokens"][b]],
                        avg_logprob=res_all["avg_logprob"][b:b + 1],
                        no_speech_prob=res_all["no_speech_prob"][b:b + 1]))
                    if pre is not None:
                        pending.append((b, pre))
                aligns = [None] * len(pending)
                if self.opt.word_timestamps and pending:
                    with timer.stage("word_ts"):
                        aligns = find_word_timestamps_batch(
                            self.model, self.tok,
                            [xa_full[b:b + 1] for b, _ in pending],
                            [p["text_tokens"] for _, p in pending],
                            [p["segment_size"] for _, p in pending],
                            alignment_heads=self.opt.alignment_heads,
                            merge=False)
                for (b, pre), al in zip(pending, aligns):
                    self._post_align(streams[b], pre, al, temperature=0.0)
                continue
            if self.opt.batched_prompts:
                # per-row prompts right-aligned in a shared bucket -> ONE
                # batched decode (greedy or beam) for all active streams;
                # the temperature ladder re-decodes only the failing rows
                with timer.stage("decode"):
                    results, temps = self._decode_batch_with_fallback(
                        xa, [streams[b] for b in active])
                pending2 = []
                for j, b in enumerate(active):
                    pre = self._pre_align(streams[b], results[j])
                    if pre is not None:
                        pending2.append((j, b, pre))
                aligns2 = [None] * len(pending2)
                if self.opt.word_timestamps and pending2:
                    with timer.stage("word_ts"):
                        aligns2 = find_word_timestamps_batch(
                            self.model, self.tok,
                            [xa[j:j + 1] for j, _, _ in pending2],
                            [p["text_tokens"] for _, _, p in pending2],
                            [p["segment_size"] for _, _, p in pending2],
                            alignment_heads=self.opt.alignment_heads,
                            merge=False)
                for (j, b, pre), al in zip(pending2, aligns2):
                    self._post_align(streams[b], pre, al,
                                     temperature=temps[j])
                continue
            # serial path (batched_prompts=False): per-stream decode with
            # per-(stream, seek) sampling seeds
            for j, b in enumerate(active):
                s = streams[b]
                prompt = s.all_tokens[s.prompt_reset_since:] \
                    if self.opt.condition_on_previous_text else None
                with timer.stage("decode"):
                    res, temp = self._decode_with_fallback(
                        xa[j:j + 1], prompt, salt=s.seek)
                self._consume_window(s, res, xa[j:j + 1], temperature=temp)

        return [dict(text=" ".join(seg["text"].strip()
                                   for seg in s.segments
                                   if seg["text"].strip()),
                     segments=s.segments, language=self.opt.language)
                for s in streams]

    # ------------------------------------------------------------------
    def _consume_window(self, s: _Stream, res, xa_b, temperature: float):
        """Apply one decoded window's results to the stream state —
        whisper's per-window block: no-speech skip, segmentation, word
        timestamps, seek rules, prompt-reset."""
        pre = self._pre_align(s, res)
        if pre is None:
            return
        alignment = None
        if self.opt.word_timestamps:
            timer = self.last_phase_timer
            with (timer.stage("word_ts") if timer else
                  contextlib.nullcontext()):
                alignment = find_word_timestamps(
                    self.model, self.tok, xa_b, pre["text_tokens"],
                    num_frames=pre["segment_size"], time_offset=0.0,
                    alignment_heads=self.opt.alignment_heads, merge=False)
        self._post_align(s, pre, alignment, temperature)

    def _pre_align(self, s: _Stream, res):
        """Per-window host logic BEFORE the word-timestamp alignment:
        no-speech skip + token->segment parsing + provisional seek.
        Returns None if the window was skipped, else the state dict the
        alignment and _post_align need."""
        opt = self.opt
        tokens = [int(t) for t in res["tokens"][0]]
        avg_lp = float(res["avg_logprob"][0])
        nsp = float(res["no_speech_prob"][0])
        previous_seek = s.seek
        segment_size = min(N_FRAMES, s.content_frames - s.seek)
        time_offset = s.seek * HOP_LENGTH / SAMPLE_RATE
        window_end_time = (s.seek + N_FRAMES) * HOP_LENGTH / SAMPLE_RATE
        content_duration = s.content_frames * HOP_LENGTH / SAMPLE_RATE

        if opt.no_speech_threshold is not None:
            should_skip = nsp > opt.no_speech_threshold
            if opt.logprob_threshold is not None and \
                    avg_lp > opt.logprob_threshold:
                should_skip = False
            if should_skip:
                s.seek += segment_size
                return None

        segments, seek_inc, single_ts_ending = parse_segments(
            tokens, self.tok.timestamp_begin, time_offset, segment_size,
            self.tok.decode)
        s.seek += seek_inc
        text_tokens = [t for seg in segments for t in seg["tokens"]
                       if t < self.tok.eot]
        return dict(segments=segments, text_tokens=text_tokens,
                    previous_seek=previous_seek, segment_size=segment_size,
                    time_offset=time_offset, window_end_time=window_end_time,
                    content_duration=content_duration,
                    single_ts_ending=single_ts_ending)

    def _post_align(self, s: _Stream, pre: Dict, alignment, temperature: float):
        """Per-window host logic AFTER the alignment: word timestamps,
        seek rules, segment bookkeeping, prompt-reset."""
        opt = self.opt
        segments = pre["segments"]
        previous_seek = pre["previous_seek"]

        if opt.word_timestamps:
            add_word_timestamps(segments, alignment, pre["time_offset"],
                                s.last_speech_timestamp, self.tok.eot)
            s.seek, segments, skip_window = apply_seek_rules(
                segments, previous_seek=previous_seek, seek=s.seek,
                segment_size=pre["segment_size"],
                time_offset=pre["time_offset"],
                window_end_time=pre["window_end_time"],
                content_frames=s.content_frames,
                content_duration=pre["content_duration"],
                single_timestamp_ending=pre["single_ts_ending"],
                threshold=opt.hallucination_silence_threshold,
                last_speech_timestamp=s.last_speech_timestamp)
            # termination guard (not in whisper): never move backwards
            s.seek = max(s.seek, previous_seek + 1)
            if skip_window:
                return
            word_ends = [w["end"] for seg in segments
                         for w in seg["words"]]
            if word_ends:
                s.last_speech_timestamp = word_ends[-1]

        # clear instantaneous / empty segments (whisper keeps the rows)
        for seg in segments:
            if seg["start"] == seg["end"] or not seg["text"].strip():
                seg["text"] = ""
                seg["tokens"] = []
                seg["words"] = []
        s.segments.extend(segments)
        # whisper extends all_tokens with each segment's FULL token list —
        # timestamp tokens included — after the empty-segment clearing; the
        # next window's condition_on_previous_text prompt is sliced from it
        s.all_tokens.extend(t for seg in segments for t in seg["tokens"])
        if not opt.condition_on_previous_text or temperature > 0.5:
            # do not feed the prompt tokens if a high temperature was used
            s.prompt_reset_since = len(s.all_tokens)
