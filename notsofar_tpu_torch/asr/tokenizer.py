"""Whisper tokenizer: byte-level BPE + special/timestamp token layout.

openai-whisper ships tiktoken vocabularies (gpt2.tiktoken /
multilingual.tiktoken: base64-encoded byte strings with ranks). This module
reads that format when a vocabulary file is available (zero-egress
environments can mount one next to the checkpoints) and otherwise falls
back to a pure byte-level tokenizer with the same special-token layout so
the full decoding pipeline stays testable end-to-end.

Copy of notsofar_tpu/asr/tokenizer.py (framework-free; the port keeps its
own copy instead of importing the JAX package).
"""
import base64
import os
from dataclasses import dataclass, field
from functools import lru_cache
from typing import Dict, List, Optional, Sequence, Tuple

# Whisper's language registry order defines the language-token ids.
LANGUAGES = (
    "en zh de es ru ko fr ja pt tr pl ca nl ar sv it id hi fi vi he uk el ms "
    "cs ro da hu ta no th ur hr bg lt la mi ml cy sk te fa lv bn sr az sl kn "
    "et mk br eu is hy ne mn bs kk sq sw gl mr pa si km sn yo so af oc ka be "
    "tg sd gu am yi lo uz fo ht ps tk nn mt sa lb my bo tl mg as tt haw ln "
    "ha ba jw su").split()
LANGUAGES_V3 = LANGUAGES + ["yue"]


@dataclass
class SpecialTokens:
    eot: int
    sot: int
    languages: Dict[str, int]
    translate: int
    transcribe: int
    sot_lm: int
    sot_prev: int
    no_speech: int
    no_timestamps: int
    timestamp_begin: int

    def sot_sequence(self, language: Optional[str] = "en",
                     task: str = "transcribe") -> List[int]:
        seq = [self.sot]
        if language is not None:
            seq.append(self.languages[language])
            seq.append(self.transcribe if task == "transcribe"
                       else self.translate)
        return seq


def special_layout(n_base_vocab: int, multilingual: bool,
                   num_languages: int) -> SpecialTokens:
    """Special-token layout (whisper convention).

    Multilingual encodings place <|endoftext|> AFTER the base vocab; the
    GPT-2 (.en) encoding already contains it as its last base token
    (rank n_base-1). Both append the same special set — sot, the language
    tokens, tasks, lm/prev markers, nospeech, notimestamps, then 1501
    timestamp tokens.
    """
    if multilingual:
        eot = n_base_vocab
        sot = eot + 1
    else:
        eot = n_base_vocab - 1   # <|endoftext|> is the last base token
        sot = n_base_vocab
    langs = LANGUAGES_V3[:num_languages]
    lang_ids = {l: sot + 1 + i for i, l in enumerate(langs)}
    translate = sot + 1 + num_languages
    transcribe = translate + 1
    sot_lm = transcribe + 1
    sot_prev = sot_lm + 1
    no_speech = sot_prev + 1
    no_timestamps = no_speech + 1
    timestamp_begin = no_timestamps + 1
    return SpecialTokens(eot, sot, lang_ids, translate, transcribe, sot_lm,
                         sot_prev, no_speech, no_timestamps, timestamp_begin)


class BpeVocab:
    """tiktoken-format byte-level BPE (rank table)."""

    def __init__(self, ranks: Dict[bytes, int]):
        self.ranks = ranks
        self.decoder = {v: k for k, v in ranks.items()}

    @staticmethod
    def load(path) -> "BpeVocab":
        ranks = {}
        with open(path, "rb") as f:
            for line in f:
                if not line.strip():
                    continue
                tok, rank = line.split()
                ranks[base64.b64decode(tok)] = int(rank)
        return BpeVocab(ranks)

    def encode_bytes(self, bs: bytes) -> List[int]:
        """Greedy lowest-rank pair merging (standard BPE)."""
        parts: List[bytes] = [bytes([b]) for b in bs]
        while len(parts) > 1:
            best_rank, best_i = None, None
            for i in range(len(parts) - 1):
                r = self.ranks.get(parts[i] + parts[i + 1])
                if r is not None and (best_rank is None or r < best_rank):
                    best_rank, best_i = r, i
            if best_i is None:
                break
            parts = (parts[:best_i] + [parts[best_i] + parts[best_i + 1]]
                     + parts[best_i + 2:])
        out = []
        for p in parts:
            if p in self.ranks:
                out.append(self.ranks[p])
            else:  # unmergeable unknown byte (shouldn't happen with full vocab)
                out.extend(self.ranks.get(bytes([b]), 0) for b in p)
        return out

    def decode_bytes(self, ids: Sequence[int]) -> bytes:
        return b"".join(self.decoder.get(i, b"") for i in ids)


class WhisperTokenizer:
    """encode/decode + special ids, mirrors whisper.tokenizer behavior."""

    def __init__(self, vocab: Optional[BpeVocab], n_base_vocab: int,
                 multilingual: bool = True, num_languages: int = 99,
                 language: str = "en", task: str = "transcribe"):
        self.vocab = vocab
        self.n_base_vocab = n_base_vocab
        self.specials = special_layout(n_base_vocab, multilingual,
                                       num_languages)
        self.language = language
        self.task = task
        s = self.specials
        self.eot = s.eot
        self.sot = s.sot
        self.no_speech = s.no_speech
        self.no_timestamps = s.no_timestamps
        self.timestamp_begin = s.timestamp_begin
        self.sot_sequence = s.sot_sequence(language, task)

    # -- text <-> ids ------------------------------------------------------
    def encode(self, text: str) -> List[int]:
        if self.vocab is None:
            return list(text.encode("utf-8"))
        return self.vocab.encode_bytes(text.encode("utf-8"))

    def decode(self, ids: Sequence[int]) -> str:
        ids = [i for i in ids if i < self.eot]
        if self.vocab is None:
            return bytes(i for i in ids if i < 256).decode("utf-8",
                                                           errors="replace")
        return self.vocab.decode_bytes(ids).decode("utf-8", errors="replace")

    def decode_with_timestamps(self, ids: Sequence[int]) -> str:
        parts = []
        chunk: List[int] = []
        for i in ids:
            if i >= self.timestamp_begin:
                if chunk:
                    parts.append(self.decode(chunk))
                    chunk = []
                parts.append(f"<|{(i - self.timestamp_begin) * 0.02:.2f}|>")
            else:
                chunk.append(i)
        if chunk:
            parts.append(self.decode(chunk))
        return "".join(parts)

    def timestamp_time(self, token: int) -> float:
        return (token - self.timestamp_begin) * 0.02

    # -- word splitting (for word-level timestamps) -----------------------
    def split_to_word_tokens(self, ids: Sequence[int]
                             ) -> Tuple[List[str], List[List[int]]]:
        """Group text tokens into space-prefixed words (whisper's
        split_tokens_on_spaces simplified for space-delimited languages)."""
        words: List[str] = []
        word_tokens: List[List[int]] = []
        for tid in ids:
            if tid >= self.eot:
                continue
            piece = self.decode([tid])
            starts_new = piece.startswith(" ") or not words
            special_punct = piece.strip() in {",", ".", "?", "!", ":", ";",
                                              "'", '"', ")", "]", "}"}
            if starts_new and not special_punct:
                words.append(piece)
                word_tokens.append([tid])
            else:
                if not words:
                    words.append(piece)
                    word_tokens.append([tid])
                else:
                    words[-1] += piece
                    word_tokens[-1].append(tid)
        return words, word_tokens


def load_tokenizer(model_name: str, dims_n_vocab: int,
                   vocab_path: Optional[str] = None,
                   language: str = "en") -> WhisperTokenizer:
    """Build the tokenizer for a model. Uses a tiktoken vocabulary file when
    available (searched next to checkpoints via WHISPER_VOCAB_PATH or the
    explicit argument), else the byte-level fallback."""
    multilingual = not model_name.endswith(".en")
    num_languages = 100 if dims_n_vocab == 51866 else 99
    # layout arithmetic:
    #   multilingual: n_vocab = base + 1(eot) + 1(sot) + L + 2(tasks)
    #                 + 2(lm, prev) + 1(nospeech) + 1(nots) + 1501(ts)
    #   gpt2 (.en):   eot is inside base ->  n_vocab = base + 1(sot) + ...
    tail = num_languages + 2 + 2 + 1 + 1 + 1501
    if multilingual:
        n_base = dims_n_vocab - (2 + tail)
    else:
        n_base = dims_n_vocab - (1 + tail)
    vocab = None
    path = vocab_path or os.environ.get("WHISPER_VOCAB_PATH")
    if path and os.path.exists(path):
        vocab = BpeVocab.load(path)
    return WhisperTokenizer(vocab, n_base, multilingual, num_languages,
                            language=language)
