"""CHiME-8 English text normalizer (the frozen scoring normalizer).

Copy of notsofar_tpu/utils/text_norm/english.py, the behavioral rebuild of
the NOTSOFAR baseline's chime8 normalizer, which in turn aligns with
chimechallenge/chime-utils. Properties preserved:

1. Idempotency — normalizing twice returns the same string.
2. Reverse number normalization (numerals -> spelled-out words, 0..1000),
   see ArabicToSpelled.
3. Filler removal after canonicalization: hmm/uh/ah/eh dropped.
4. UK -> US spelling via the tysto list (lemma-compressed in uk_us.py).

The exact pipeline order matters for parity and is kept 1:1:
lowercase -> bracket/paren removal -> pre-spelling fixups (shan't/han't/
ain't) -> apostrophe space collapse -> replacers (non-verbal sounds, common
contractions, titles, general contractions) -> digit comma/period cleanup ->
symbol+diacritic strip (keeping .%$¢€£) -> reverse numbers -> UK->US ->
residual symbol strip -> filler removal -> whitespace squeeze.
"""
import re
from typing import Optional

from notsofar_tpu_torch.utils.text_norm.basic import remove_symbols_and_diacritics
from notsofar_tpu_torch.utils.text_norm.numbers import ArabicToSpelled, SpelledToArabic
from notsofar_tpu_torch.utils.text_norm.uk_us import build_uk_to_us

# Applied before the apostrophe collapse; mirrors pre_english.json.
_PRE_WORD_MAP = {
    "shan't": "shall not",
    "han't": "has not",
    "ain't": "ain not",
}

_REPLACERS = {
    # common non-verbal sounds canonicalized
    r"\b(hm+)\b|\b(mhm)\b|\b(mm+)\b|\b(m+h)\b|\b(hm+)\b|\b(um+)\b|\b(uhm+)\b":
        "hmm",
    r"\b(a+h+)\b|\b(ha+)\b": "ah",
    r"[!?.]+(?=$|\s)": "",  # trailing punctuation runs
    r"\b(o+h+)\b|\b(h+o+)\b": "oh",
    r"\b(u+h+)\b|\b(h+u+)\b|\b(h+u+h+)\b": "uh",
    # common contractions / spelling variants
    r"\b(wi\sfi)\b": "wifi",
    r"\b(goin)\b": "going",
    r"\wi-fi\b": "wifi",
    r"\bwon't\b": "will not",
    r"\bcan't\b": "can not",
    r"\blet's\b": "let us",
    r"\bain't\b": "aint",
    r"\by'all\b": "you all",
    r"\bwanna\b": "want to",
    r"\bgotta\b": "got to",
    r"\bgonna\b": "going to",
    r"\bi'ma\b": "i am going to",
    r"\bimma\b": "i am going to",
    r"\bwoulda\b": "would have",
    r"\bcoulda\b": "could have",
    r"\bshoulda\b": "should have",
    r"\bma'am\b": "madam",
    r"\bokay\b": "ok",
    r"\bsetup\b": "set up",
    r"\beveryday\b": "every day",
    # titles / prefixes
    r"\bmr\b": "mister ",
    r"\bmrs\b": "missus ",
    r"\bst\b": "saint ",
    r"\bdr\b": "doctor ",
    r"\bprof\b": "professor ",
    r"\bcapt\b": "captain ",
    r"\bgov\b": "governor ",
    r"\bald\b": "alderman ",
    r"\bgen\b": "general ",
    r"\bsen\b": "senator ",
    r"\brep\b": "representative ",
    r"\bpres\b": "president ",
    r"\brev\b": "reverend ",
    r"\bhon\b": "honorable ",
    r"\basst\b": "assistant ",
    r"\bassoc\b": "associate ",
    r"\blt\b": "lieutenant ",
    r"\bcol\b": "colonel ",
    r"\bjr\b": "junior ",
    r"\bsr\b": "senior ",
    r"\besq\b": "esquire ",
    # perfect-tense disambiguation before generic expansion
    r"'d been\b": " had been",
    r"'s been\b": " has been",
    r"'d gone\b": " had gone",
    r"'s gone\b": " has gone",
    r"'d done\b": " had done",
    r"'s got\b": " has got",
    # general contractions
    r"n't\b": " not",
    r"'re\b": " are",
    r"'s\b": " is",
    r"'d\b": " would",
    r"'ll\b": " will",
    r"'t\b": " not",
    r"'ve\b": " have",
    r"'m\b": " am",
}

_FILLERS = ("hmm", "uh", "ah", "eh")


class _WordMapper:
    """Whole-token mapping over whitespace-split words."""

    def __init__(self, mapping: dict):
        self.mapping = mapping

    def __call__(self, s: str) -> str:
        return " ".join(self.mapping.get(w, w) for w in s.split())


class EnglishTextNormalizer:
    """The chime8 normalizer; callable str -> str, idempotent."""

    def __init__(self, standardize_numbers: bool = False,
                 standardize_numbers_rev: bool = True,
                 remove_fillers: bool = True):
        if standardize_numbers:
            assert not standardize_numbers_rev, \
                "forward and reverse number normalization are exclusive"
            self._numbers: Optional[SpelledToArabic] = SpelledToArabic()
        else:
            self._numbers = None
        self._numbers_rev = ArabicToSpelled() if standardize_numbers_rev else None
        self._uk_us = _WordMapper(build_uk_to_us())
        self._pre_map = _WordMapper(_PRE_WORD_MAP)
        self._remove_fillers = remove_fillers
        self._filler_re = re.compile(r"\b(" + "|".join(_FILLERS) + r")\b")

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)   # bracketed spans
        s = re.sub(r"\(([^)]+?)\)", "", s)         # parenthesized spans
        s = self._pre_map(s)
        s = re.sub(r"\s+'", "'", s)                # space before apostrophe

        for pattern, replacement in _REPLACERS.items():
            s = re.sub(pattern, replacement, s)

        s = re.sub(r"(\d),(\d)", r"\1\2", s)       # commas inside numbers
        s = re.sub(r"\.([^0-9]|$)", r" \1", s)     # periods not in numbers
        s = remove_symbols_and_diacritics(s, keep=".%$¢€£")

        if self._numbers is not None:
            s = self._numbers(s)
        if self._numbers_rev is not None:
            s = self._numbers_rev(s)
        s = self._uk_us(s)

        # strip numeric symbols not adjacent to digits
        s = re.sub(r"[.$¢€£]([^0-9])", r" \1", s)
        s = re.sub(r"([^0-9])%", r"\1 ", s)

        if self._remove_fillers:
            s = self._filler_re.sub("", s)

        s = re.sub(r"\s+", " ", s)
        return re.sub(r"^\s+|\s+$", "", s)
