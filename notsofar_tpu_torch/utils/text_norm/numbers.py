"""Number normalization for English text.

Copy of notsofar_tpu/utils/text_norm/numbers.py. Two directions, rebuilt
from the documented contracts of the NOTSOFAR baseline's english.py:

* ``SpelledToArabic`` — spelled-out numbers -> arabic numerals, the classic
  Whisper-style normalizer (english.py:12-448). Handles suffixes (1960s,
  32nd), currency symbols, 'double/triple' digit repetition, decimal
  'point' chains, and 'and a half' -> 'point five'.
* ``ArabicToSpelled`` — the CHiME-8 *reverse* direction actually used for
  scoring (english.py:451-524): numerals 0..1000 -> spelled-out words so
  that systems without rich numeral token sets are not penalized.
"""
import re
from fractions import Fraction
from typing import Iterator, List, Optional, Union

_ONES_WORDS = ["one", "two", "three", "four", "five", "six", "seven",
               "eight", "nine", "ten", "eleven", "twelve", "thirteen",
               "fourteen", "fifteen", "sixteen", "seventeen", "eighteen",
               "nineteen"]
_TENS_WORDS = {"twenty": 20, "thirty": 30, "forty": 40, "fifty": 50,
               "sixty": 60, "seventy": 70, "eighty": 80, "ninety": 90}
_MULTIPLIER_WORDS = {
    "hundred": 100, "thousand": 10 ** 3, "million": 10 ** 6,
    "billion": 10 ** 9, "trillion": 10 ** 12, "quadrillion": 10 ** 15,
    "quintillion": 10 ** 18, "sextillion": 10 ** 21, "septillion": 10 ** 24,
    "octillion": 10 ** 27, "nonillion": 10 ** 30, "decillion": 10 ** 33,
}

_NUMERIC_RE = re.compile(r"^\d+(\.\d+)?$")


def _ordinal_of(word: str, value: int) -> str:
    special = {1: "first", 2: "second", 3: "third", 5: "fifth", 12: "twelfth"}
    if value in special:
        return special[value]
    return word + ("h" if word.endswith("t") else "th")


class SpelledToArabic:
    """Spelled-out English numbers -> numerals (whisper-style forward
    normalization). State-machine over the word stream."""

    def __init__(self):
        self.zeros = {"o", "zero"}
        self.ones = {w: i for i, w in enumerate(_ONES_WORDS, start=1)}
        self.ones_plural = {("sixes" if w == "six" else w + "s"): (v, "s")
                            for w, v in self.ones.items()}
        self.ones_ordinal = {"zeroth": (0, "th")}
        for w, v in self.ones.items():
            suffix = {1: "st", 2: "nd", 3: "rd"}.get(v, "th")
            self.ones_ordinal[_ordinal_of(w, v)] = (v, suffix)
        self.ones_suffixed = {**self.ones_plural, **self.ones_ordinal}

        self.tens = dict(_TENS_WORDS)
        self.tens_plural = {w.replace("y", "ies"): (v, "s")
                            for w, v in self.tens.items()}
        self.tens_ordinal = {w.replace("y", "ieth"): (v, "th")
                             for w, v in self.tens.items()}
        self.tens_suffixed = {**self.tens_plural, **self.tens_ordinal}

        self.multipliers = dict(_MULTIPLIER_WORDS)
        self.multipliers_suffixed = {}
        for w, v in self.multipliers.items():
            self.multipliers_suffixed[w + "s"] = (v, "s")
            self.multipliers_suffixed[w + "th"] = (v, "th")

        self.decimals = set(self.ones) | set(self.tens) | self.zeros
        self.preceding_prefixers = {"minus": "-", "negative": "-",
                                    "plus": "+", "positive": "+"}
        self.following_prefixers = {"pound": "£", "pounds": "£",
                                    "euro": "€", "euros": "€",
                                    "dollar": "$", "dollars": "$",
                                    "cent": "¢", "cents": "¢"}
        self.prefixes = set(self.preceding_prefixers.values()) | \
            set(self.following_prefixers.values())
        self.suffixers = {"per": {"cent": "%"}, "percent": "%"}
        self.specials = {"and", "double", "triple", "point"}
        self.words = set().union(
            self.zeros, self.ones, self.ones_suffixed, self.tens,
            self.tens_suffixed, self.multipliers, self.multipliers_suffixed,
            self.preceding_prefixers, self.following_prefixers,
            self.suffixers, self.specials)

    # -- the stream processor ----------------------------------------------
    def _stream(self, words: List[str]) -> Iterator[str]:
        prefix: Optional[str] = None
        value: Optional[Union[str, int]] = None
        skip = False

        def frac(s):
            try:
                return Fraction(s)
            except ValueError:
                return None

        def flush(result):
            nonlocal prefix, value
            out = str(result)
            if prefix is not None:
                out = prefix + out
            prefix = None
            value = None
            return out

        n = len(words)
        for i, current in enumerate(words):
            if skip:
                skip = False
                continue
            prev = words[i - 1] if i > 0 else None
            nxt = words[i + 1] if i + 1 < n else None
            next_is_numeric = nxt is not None and _NUMERIC_RE.match(nxt)
            has_prefix = current[0] in self.prefixes
            bare = current[1:] if has_prefix else current

            if _NUMERIC_RE.match(bare):
                f = frac(bare)
                if value is not None:
                    if isinstance(value, str) and value.endswith("."):
                        value = str(value) + str(current)
                        continue
                    yield flush(value)
                if has_prefix:
                    prefix = current[0]
                value = f.numerator if f.denominator == 1 else bare
            elif current not in self.words:
                if value is not None:
                    yield flush(value)
                yield flush(current)
            elif current in self.zeros:
                value = str(value or "") + "0"
            elif current in self.ones:
                v = self.ones[current]
                if value is None:
                    value = v
                elif isinstance(value, str) or prev in self.ones:
                    if prev in self.tens and v < 10:
                        value = value[:-1] + str(v)
                    else:
                        value = str(value) + str(v)
                elif v < 10:
                    value = value + v if value % 10 == 0 else str(value) + str(v)
                else:
                    value = value + v if value % 100 == 0 else str(value) + str(v)
            elif current in self.ones_suffixed:
                v, suffix = self.ones_suffixed[current]
                if value is None:
                    yield flush(str(v) + suffix)
                elif isinstance(value, str) or prev in self.ones:
                    if prev in self.tens and v < 10:
                        yield flush(value[:-1] + str(v) + suffix)
                    else:
                        yield flush(str(value) + str(v) + suffix)
                elif v < 10:
                    if value % 10 == 0:
                        yield flush(str(value + v) + suffix)
                    else:
                        yield flush(str(value) + str(v) + suffix)
                else:
                    if value % 100 == 0:
                        yield flush(str(value + v) + suffix)
                    else:
                        yield flush(str(value) + str(v) + suffix)
                value = None
            elif current in self.tens:
                v = self.tens[current]
                if value is None:
                    value = v
                elif isinstance(value, str):
                    value = str(value) + str(v)
                else:
                    value = value + v if value % 100 == 0 else str(value) + str(v)
            elif current in self.tens_suffixed:
                v, suffix = self.tens_suffixed[current]
                if value is None:
                    yield flush(str(v) + suffix)
                elif isinstance(value, str):
                    yield flush(str(value) + str(v) + suffix)
                elif value % 100 == 0:
                    yield flush(str(value + v) + suffix)
                else:
                    yield flush(str(value) + str(v) + suffix)
            elif current in self.multipliers:
                mult = self.multipliers[current]
                if value is None:
                    value = mult
                elif isinstance(value, str) or value == 0:
                    f = frac(value)
                    p = f * mult if f is not None else None
                    if p is not None and p.denominator == 1:
                        value = p.numerator
                    else:
                        yield flush(value)
                        value = mult
                else:
                    value = (value // 1000) * 1000 + (value % 1000) * mult
            elif current in self.multipliers_suffixed:
                mult, suffix = self.multipliers_suffixed[current]
                if value is None:
                    yield flush(str(mult) + suffix)
                elif isinstance(value, str):
                    f = frac(value)
                    p = f * mult if f is not None else None
                    if p is not None and p.denominator == 1:
                        yield flush(str(p.numerator) + suffix)
                    else:
                        yield flush(value)
                        yield flush(str(mult) + suffix)
                else:
                    value = (value // 1000) * 1000 + (value % 1000) * mult
                    yield flush(str(value) + suffix)
                value = None
            elif current in self.preceding_prefixers:
                if value is not None:
                    yield flush(value)
                if nxt in self.words or next_is_numeric:
                    prefix = self.preceding_prefixers[current]
                else:
                    yield flush(current)
            elif current in self.following_prefixers:
                if value is not None:
                    prefix = self.following_prefixers[current]
                    yield flush(value)
                else:
                    yield flush(current)
            elif current in self.suffixers:
                if value is not None:
                    suffix = self.suffixers[current]
                    if isinstance(suffix, dict):
                        if nxt in suffix:
                            yield flush(str(value) + suffix[nxt])
                            skip = True
                        else:
                            yield flush(value)
                            yield flush(current)
                    else:
                        yield flush(str(value) + suffix)
                else:
                    yield flush(current)
            elif current in self.specials:
                if nxt not in self.words and not next_is_numeric:
                    if value is not None:
                        yield flush(value)
                    yield flush(current)
                elif current == "and":
                    if prev not in self.multipliers:
                        if value is not None:
                            yield flush(value)
                        yield flush(current)
                elif current in ("double", "triple"):
                    if nxt in self.ones or nxt in self.zeros:
                        repeats = 2 if current == "double" else 3
                        digit = self.ones.get(nxt, 0)
                        value = str(value or "") + str(digit) * repeats
                        skip = True
                    else:
                        if value is not None:
                            yield flush(value)
                        yield flush(current)
                elif current == "point":
                    if nxt in self.decimals or next_is_numeric:
                        value = str(value or "") + "."
                else:
                    raise ValueError(f"unexpected token: {current}")
            else:
                raise ValueError(f"unexpected token: {current}")

        if value is not None:
            yield flush(value)

    def _pre(self, s: str) -> str:
        # "<number> and a half" -> "<number> point five"
        parts = re.split(r"\band\s+a\s+half\b", s)
        merged = []
        for i, part in enumerate(parts):
            if not part.strip():
                continue
            merged.append(part)
            if i != len(parts) - 1:
                last = part.rsplit(maxsplit=2)[-1]
                if last in self.decimals or last in self.multipliers:
                    merged.append("point five")
                else:
                    merged.append("and a half")
        s = " ".join(merged)
        s = re.sub(r"([a-z])([0-9])", r"\1 \2", s)
        s = re.sub(r"([0-9])([a-z])", r"\1 \2", s)
        s = re.sub(r"([0-9])\s+(st|nd|rd|th|s)\b", r"\1\2", s)
        return s

    def _post(self, s: str) -> str:
        def cents_merge(m):
            try:
                return f"{m.group(1)}{m.group(2)}.{int(m.group(3)):02d}"
            except ValueError:
                return m.string

        def cents_only(m):
            try:
                return f"¢{int(m.group(1))}"
            except ValueError:
                return m.string

        s = re.sub(r"([€£$])([0-9]+) (?:and )?¢([0-9]{1,2})\b", cents_merge, s)
        s = re.sub(r"[€£$]0.([0-9]{1,2})\b", cents_only, s)
        s = re.sub(r"\b1(s?)\b", r"one\1", s)
        return s

    def __call__(self, s: str) -> str:
        s = self._pre(s)
        s = " ".join(w for w in self._stream(s.split()) if w is not None)
        return self._post(s)


class ArabicToSpelled:
    """Numerals 0..1000 (plus $/% and suffixed forms) -> spelled-out words.

    The CHiME-8 scoring direction (english.py:451-524). Known ambiguity
    caveats carried over: only 0..1000; no sign handling; '000' becomes
    'thousand' so '70 000' reads naturally.
    """

    def __init__(self):
        ones = {w: i for i, w in enumerate(_ONES_WORDS, start=1)}
        self._int_to_ones = {v: w for w, v in ones.items()}
        self._int_to_tens = {v: w for w, v in _TENS_WORDS.items()}
        self._suffixed = {}
        self._suffixed["0th"] = "zeroth"
        for w, v in ones.items():
            # numeral+'s' maps to the spelled plural ('6s' -> 'sixes')
            self._suffixed[str(v) + "s"] = ("sixes" if w == "six" else w + "s")
            suffix = {1: "st", 2: "nd", 3: "rd"}.get(v, "th")
            self._suffixed[str(v) + suffix] = _ordinal_of(w, v)
        for w, v in _TENS_WORDS.items():
            self._suffixed[str(v) + "s"] = w.replace("y", "ies")
            self._suffixed[str(v) + "th"] = w.replace("y", "ieth")

    def _spell(self, w: str) -> str:
        if w.isdigit():
            num = int(w)
            if w == "000":
                return "thousand"
            if num == 0:
                return "zero"
            if num == 100:
                return "hundred"
            if num == 1000:
                return "thousand"
            if 0 < num < 1000:
                hundreds, rem = divmod(num, 100)
                words = []
                if hundreds:
                    words.append(f"{self._int_to_ones[hundreds]} hundred")
                if 0 < rem <= 19:
                    words.append(self._int_to_ones[rem])
                else:
                    tens, ones = divmod(rem, 10)
                    if tens:
                        words.append(self._int_to_tens[tens * 10])
                    if ones:
                        words.append(self._int_to_ones[ones])
                return " ".join(words)
            return w  # out of range, leave as-is
        return self._suffixed.get(w, w)

    def __call__(self, s: str) -> str:
        s = re.sub(r"\$(\d+(\.\d+)?)", r"\1 dollars", s)
        s = re.sub(r"(\d+(\.\d+)?)%", r"\1 percent", s)
        return " ".join(self._spell(w) for w in s.split())
