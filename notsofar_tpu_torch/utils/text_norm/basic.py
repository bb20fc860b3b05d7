"""Unicode symbol/diacritic stripping + basic normalizer.

Copy of notsofar_tpu/utils/text_norm/basic.py, the behavioral rebuild of
the NOTSOFAR baseline's basic normalizer: NFKD decomposition,
drop combining marks (category Mn), replace marks/symbols/punctuation with a
space, with a handful of non-decomposable letters mapped explicitly.
"""
import re
import unicodedata

# Non-ASCII letters whose NFKD form does not separate into base + mark.
_SPECIAL_LETTERS = {
    "œ": "oe", "Œ": "OE",
    "ø": "o", "Ø": "O",
    "æ": "ae", "Æ": "AE",
    "ß": "ss", "ẞ": "SS",
    "đ": "d", "Đ": "D",
    "ð": "d", "Ð": "D",
    "þ": "th", "Þ": "th",
    "ł": "l", "Ł": "L",
}


def remove_symbols_and_diacritics(s: str, keep: str = "") -> str:
    """NFKD-normalize, drop diacritics, space out symbols/punctuation."""
    out = []
    for c in unicodedata.normalize("NFKD", s):
        if c in keep:
            out.append(c)
        elif c in _SPECIAL_LETTERS:
            out.append(_SPECIAL_LETTERS[c])
        else:
            cat = unicodedata.category(c)
            if cat == "Mn":
                continue
            out.append(" " if cat[0] in "MSP" else c)
    return "".join(out)


def remove_symbols(s: str) -> str:
    """NFKC-normalize and space out marks/symbols/punctuation (keep
    diacritics)."""
    return "".join(
        " " if unicodedata.category(c)[0] in "MSP" else c
        for c in unicodedata.normalize("NFKC", s))


class BasicTextNormalizer:
    """Lowercase, drop bracketed/parenthesized spans, strip symbols."""

    def __init__(self, remove_diacritics: bool = False,
                 split_letters: bool = False):
        self._clean = (remove_symbols_and_diacritics if remove_diacritics
                       else remove_symbols)
        self._split_letters = split_letters

    def __call__(self, s: str) -> str:
        s = s.lower()
        s = re.sub(r"[<\[][^>\]]*[>\]]", "", s)
        s = re.sub(r"\(([^)]+?)\)", "", s)
        s = self._clean(s).lower()
        if self._split_letters:
            import regex
            s = " ".join(regex.findall(r"\X", s, regex.U))
        return re.sub(r"\s+", " ", s)
