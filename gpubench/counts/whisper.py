"""Operations and bytes a Whisper window needs, from its shapes.

A frozen copy of the port's ``utils/flops.py`` Whisper counts, corrected:

* a decode step reads the decoder weights it uses once: every block's
  self-attention q/k/v/out, the cross-attention's query and out (its key
  and value projections run once per window, at the call's set-up), fc1,
  fc2, and the tied embedding for the logits (1,280 x 51,866); not the
  cross-attention's key and value weights, and not the learned positions
  beyond one row;
* the cross-attention keys and values are read once per window a step,
  whatever the number of beams that share them;
* a row's self-attention cache is read up to the current position; a
  stream's prompt part is shared by its beams and counted once;
* operations count each multiply-add as 2; a step's logits are the full
  vocabulary for each row, the prefill's only at the two positions the
  decode reads (the no-speech probability and the next token), the
  alignment pass's the text vocabulary at every position.

Counts hold what the algorithm needs, so a kernel that reads only what it
must can never read above 100% of a roofline from them.
"""
from typing import Dict, Sequence

BF16 = 2


def _dense_params_per_block(D: int) -> int:
    """Decoder block matrices a decode step reads: self q, k, v, out;
    cross q, out; fc1 and fc2 (4 D wide)."""
    return 4 * D * D + 2 * D * D + 2 * 4 * D * D


def decode_step_weight_params(d: Dict) -> int:
    """Parameters one decode step's GEMVs read: the blocks' matrices and
    the logits' embedding (biases and norms are under 0.1% and left
    out)."""
    D, L, V = d["n_text_state"], d["n_text_layer"], d["n_vocab"]
    return L * _dense_params_per_block(D) + V * D


def decode_step_weight_bytes(d: Dict, dtype_bytes: int = BF16) -> int:
    return decode_step_weight_params(d) * dtype_bytes


def decode_step_bytes(d: Dict, prompt_lens: Sequence[int], beams: int,
                      step: int, dtype_bytes: int = BF16) -> int:
    """One decode step of a dispatch: the weights once, each window's
    cross-attention keys and values once, each stream's prompt cache once
    and each beam row's generated cache up to `step` (the new token's k and
    v are written: counted once more)."""
    D, L = d["n_text_state"], d["n_text_layer"]
    kv = 2 * L * D * dtype_bytes
    windows = len(prompt_lens)
    cross = windows * d["n_audio_ctx"] * kv
    prompt = sum(prompt_lens) * kv
    generated = windows * beams * (step + 1) * kv
    return decode_step_weight_bytes(d, dtype_bytes) + cross + prompt + \
        generated


def decode_call_bytes(d: Dict, prompt_lens: Sequence[int], beams: int,
                      steps: int, dtype_bytes: int = BF16) -> int:
    """Every step of one decode dispatch."""
    return sum(decode_step_bytes(d, prompt_lens, beams, s, dtype_bytes)
               for s in range(steps))


def encoder_flops(d: Dict) -> float:
    """One 30 s window through the audio encoder."""
    D, L, M = d["n_audio_state"], d["n_audio_layer"], d["n_mels"]
    T0, T = 2 * d["n_audio_ctx"], d["n_audio_ctx"]
    conv = 2 * T0 * 3 * M * D + 2 * T * 3 * D * D
    per_layer = 2 * T * (4 * D * D + 8 * D * D) + 2 * 2 * T * T * D
    return conv + L * per_layer


def decode_step_flops(d: Dict, prompt_lens: Sequence[int], beams: int,
                      step: int) -> float:
    """One decode step of a dispatch: every row's matmuls and logits, its
    self-attention over its prompt and generated tokens, its
    cross-attention over the window."""
    D, L, V = d["n_text_state"], d["n_text_layer"], d["n_vocab"]
    rows = len(prompt_lens) * beams
    dense = 2 * _dense_params_per_block(D) * L + 2 * D * V
    attn = sum(beams * L * 2 * 2 * D * (p + step + 1 + d["n_audio_ctx"])
               for p in prompt_lens)
    return rows * dense + attn


def decode_setup_flops(d: Dict, prompt_lens: Sequence[int]) -> float:
    """A dispatch's set-up: each window's cross-attention keys and values,
    and the prompt's prefill (a stream's prompt once, its beams share it)
    with the logits at two positions."""
    D, L, V = d["n_text_state"], d["n_text_layer"], d["n_vocab"]
    S = d["n_audio_ctx"]
    cross = len(prompt_lens) * L * 2 * 2 * S * D * D
    pre = 0.0
    for p in prompt_lens:
        pre += 2 * p * _dense_params_per_block(D) * L
        pre += L * 2 * 2 * D * (p * (p + 1) / 2 + p * S)
        pre += 2 * 2 * D * V
    return cross + pre


def alignment_flops(d: Dict, n_tokens: int, n_text_vocab: int) -> float:
    """The word-timing pass of one window: the decoder teacher-forced over
    n_tokens (its cross-attention keys and values projected anew), the
    text-vocabulary logits at every position."""
    D, L = d["n_text_state"], d["n_text_layer"]
    S = d["n_audio_ctx"]
    T = n_tokens
    dense = 2 * T * (4 * D * D + 2 * D * D + 8 * D * D) * L
    cross_kv = L * 2 * 2 * S * D * D
    attn = L * 2 * 2 * D * (T * (T + 1) / 2 + T * S)
    return dense + cross_kv + attn + 2 * T * D * n_text_vocab
