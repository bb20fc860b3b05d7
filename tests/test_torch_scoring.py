"""notsofar_tpu_torch's copies of the scorer (tcpWER, tcORC-WER, calc_wer,
the scoring CLI) and of the CHiME-8 text normalizer against the JAX
package's, on the same inputs: the golden cases of
tests/test_scoring_golden.py, seeded meeting-like sessions, and the
normalizer corpus of tests/test_textnorm.py. Edit counts and WER must be
equal, strings identical. The port's native cores are built from its own
copies (notsofar_tpu_torch/native) into native/build/.
"""
import json
from pathlib import Path

import numpy as np
import pandas as pd
import pytest

from notsofar_tpu.utils import scoring as jsc
from notsofar_tpu.utils.scoring import tcpwer as jtcp
from notsofar_tpu.utils.text_norm import get_txt_norm as j_txt_norm
from notsofar_tpu.utils.text_norm import numbers as jnum
from notsofar_tpu_torch.utils import native
from notsofar_tpu_torch.utils import scoring as tsc
from notsofar_tpu_torch.utils.scoring import exact_orc as texact
from notsofar_tpu_torch.utils.scoring import levenshtein as tlev
from notsofar_tpu_torch.utils.scoring import tcpwer as ttcp
from notsofar_tpu_torch.utils.scoring.seglst import SegLst as TSegLst
from notsofar_tpu_torch.utils.text_norm import get_txt_norm as t_txt_norm
from notsofar_tpu_torch.utils.text_norm import numbers as tnum
from tests.test_scoring import _random_session
from tests.test_scoring_golden import CASES as GOLDEN
from tests.test_textnorm import CASES as TN_CASES
from tests.test_textnorm import FORWARD_CASES, REVERSE_CASES

REPO = Path(__file__).resolve().parent.parent
COUNTS = ("errors", "length", "insertions", "deletions", "substitutions")


def _both(rows):
    """The same segments as a JAX-package SegLst and a port SegLst."""
    from notsofar_tpu.utils.scoring.seglst import SegLst as JSegLst
    return JSegLst([dict(r) for r in rows]), TSegLst([dict(r) for r in rows])


def _assert_same(got, want):
    for key in COUNTS + ("missed_speaker", "falarm_speaker"):
        if key in want:
            assert got[key] == want[key], key
    assert got["error_rate"] == want["error_rate"]
    if "assignment" in want:        # pairs may hold None (unmatched)
        assert sorted(map(repr, got["assignment"])) == \
            sorted(map(repr, want["assignment"]))


@pytest.mark.parametrize("case", GOLDEN, ids=lambda c: c["name"])
def test_golden_cases_match_jax(case):
    jref, tref = _both(case["ref"])
    jhyp, thyp = _both(case["hyp"])
    c = case["collar"]
    _assert_same(ttcp.tcp_wer(tref, thyp, collar=c),
                 jtcp.tcp_wer(jref, jhyp, collar=c))
    _assert_same(ttcp.tcorc_wer(tref, thyp, collar=c),
                 jtcp.tcorc_wer(jref, jhyp, collar=c))


@pytest.mark.parametrize("seed", range(4))
def test_seeded_sessions_match_jax(seed):
    """Meeting-like sessions (sequential turns, some overlap, dropped and
    inserted words), 2-3 hypothesis streams: tcpWER with the speaker
    assignment and tcORC-WER equal."""
    rng = np.random.RandomState(seed)
    words = ["alpha", "beta", "gamma", "delta", "eps"]
    ref, hyp = _random_session(rng, int(rng.randint(6, 14)),
                               int(rng.randint(2, 4)), words)
    jref, tref = _both(list(ref))
    jhyp, thyp = _both(list(hyp))
    _assert_same(ttcp.tcp_wer(tref, thyp, collar=5.0),
                 jtcp.tcp_wer(jref, jhyp, collar=5.0))
    _assert_same(ttcp.tcorc_wer(tref, thyp, collar=5.0),
                 jtcp.tcorc_wer(jref, jhyp, collar=5.0))


def test_calc_wer_matches_jax(tmp_path):
    """calc_wer over a GT dataframe and hypothesis lists: the same
    dataframe (columns and values) and the same normalized ref.json."""
    gt = pd.DataFrame([
        dict(meeting_id="MTG_0001", start_time=0.0, end_time=2.0,
             text="It costs $20, okay?", speaker_id="A"),
        dict(meeting_id="MTG_0001", start_time=2.5, end_time=5.0,
             text="good morning colour", speaker_id="B"),
        dict(meeting_id="MTG_0001", start_time=4.0, end_time=7.0,
             text="we'll meet at 3", speaker_id="A")])
    hyp = [dict(session_id="multichannel/MTG_0001_dev1", start_time=0.0,
                end_time=2.0, words="it costs twenty dollars OK",
                speaker="spk0"),
           dict(session_id="multichannel/MTG_0001_dev1", start_time=2.6,
                end_time=5.2, words="good morning color", speaker="spk1"),
           dict(session_id="multichannel/MTG_0001_dev1", start_time=4.1,
                end_time=6.8, words="we will meet at", speaker="spk1")]
    want = jsc.calc_wer(tmp_path / "jax", hyp, hyp, gt, tn="chime8",
                        collar=5)
    got = tsc.calc_wer(tmp_path / "port", hyp, hyp, gt, tn="chime8",
                       collar=5)
    pd.testing.assert_frame_equal(got, want)
    assert 0 < got.tcp_wer.iloc[0] < 1
    assert (tmp_path / "port" / "ref.json").read_text() == \
        (tmp_path / "jax" / "ref.json").read_text()


def test_scoring_cli_matches_jax(tmp_path, capsys):
    from notsofar_tpu.utils.scoring.__main__ import main as jmain
    from notsofar_tpu_torch.utils.scoring.__main__ import main as tmain
    ref = [dict(session_id="s1", speaker="A", start_time=0.0, end_time=2.0,
                words="twenty five dollars"),
           dict(session_id="s1", speaker="B", start_time=1.0, end_time=3.0,
                words="hello there")]
    hyp = [dict(session_id="s1", speaker="0", start_time=0.1, end_time=2.1,
                words="$25"),
           dict(session_id="s1", speaker="1", start_time=1.0, end_time=3.0,
                words="hello")]
    rp, hp = tmp_path / "ref.json", tmp_path / "hyp.json"
    rp.write_text(json.dumps(ref))
    hp.write_text(json.dumps(hyp))
    for metric in ("tcpwer", "tcorcwer"):
        outs = []
        for main in (jmain, tmain):
            main([metric, "-r", str(rp), "-H", str(hp)])
            outs.append(json.loads(capsys.readouterr().out))
        assert outs[0] == outs[1]
        assert outs[1]["errors"] == 1


@pytest.mark.parametrize("inp", [c[0] for c in TN_CASES])
def test_chime8_normalizer_matches_jax(inp):
    tn, jn = t_txt_norm("chime8"), j_txt_norm("chime8")
    assert tn(inp) == jn(inp)
    assert tn(tn(inp)) == tn(inp)


@pytest.mark.parametrize("inp", [c[0] for c in REVERSE_CASES + FORWARD_CASES])
def test_number_normalizers_match_jax(inp):
    assert tnum.ArabicToSpelled()(inp) == jnum.ArabicToSpelled()(inp)
    assert tnum.SpelledToArabic()(inp) == jnum.SpelledToArabic()(inp)


def test_native_cores_are_built_from_the_port_copy():
    """The port's tclev and orc cores load from notsofar_tpu_torch/native/
    build/, built from the port's own sources; the exact ORC agrees with
    the production tcORC on a seeded session."""
    assert tlev.core_name() == "native"
    build = REPO / "notsofar_tpu_torch" / "native" / "build"
    assert native.core_path("tclev").parent == build
    assert native.core_path("tclev").exists()
    assert native.load_native("orc") is not None
    assert native.core_path("orc").parent == build
    rng = np.random.RandomState(7)
    ref, hyp = _random_session(rng, 8, 2, ["a", "b", "c"])
    _, tref = _both(list(ref))
    _, thyp = _both(list(hyp))
    exact = texact.tcorc_wer_exact(tref, thyp, collar=5.0)
    assert exact["errors"] == ttcp.tcorc_wer(tref, thyp,
                                             collar=5.0)["errors"]
