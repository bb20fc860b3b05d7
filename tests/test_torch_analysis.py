"""notsofar_tpu_torch.utils.results_analysis, plot_utils and
profiling.trace against the JAX package's modules, on the CPU.

The WER frame, metadata, masks and STFTs are made from numpy seeds. The
separation-method wavs go through each package's synthesis iSTFT (the
tiny SC CSS model of tests/test_css_engine.py on both sides).
"""
import json

import numpy as np
import pandas as pd
import pytest
import scipy.io.wavfile as wf
import torch

from notsofar_tpu.css.engine import CssCfg as JCssCfg
from notsofar_tpu.css.engine import CssEngine as JCssEngine
from notsofar_tpu.utils import plot_utils as jplot
from notsofar_tpu.utils import results_analysis as jra
from notsofar_tpu_torch.css.engine import CssCfg, CssEngine
from notsofar_tpu_torch.utils import plot_utils as tplot
from notsofar_tpu_torch.utils import profiling
from notsofar_tpu_torch.utils import results_analysis as tra
from tests.test_css_engine import SC
from tests.test_torch_css_engine import PORT_SC

TAGS = ["#NaturalMeeting", "#TalkNearWhiteboard", "#Laughter",
        "#CrossTalk"]


def wer_frames(seed: int, meetings: int = 12, per_meeting: int = 3):
    """(session WER frame, GT metadata frame): sessions MTG_<n>_<device>
    with seeded tcpWER / tcORC-WER, one hashtag set per meeting."""
    rng = np.random.RandomState(seed)
    rows, meta = [], []
    for m in range(meetings):
        mid = f"MTG_{30000 + m}"
        tags = rng.choice(TAGS, size=rng.randint(1, 4), replace=False)
        meta.append(dict(meeting_id=mid, Hashtags=", ".join(tags)))
        for d in range(per_meeting):
            tcp = float(rng.uniform(0.1, 0.6))
            rows.append(dict(session_id=f"multichannel/{mid}_plaza_{d}",
                             tcp_wer=tcp,
                             tcorc_wer=tcp - float(rng.uniform(0, 0.05))))
    return pd.DataFrame(rows), pd.DataFrame(meta)


@pytest.mark.parametrize("kw", [
    dict(), dict(ci_over_sessions=True), dict(min_samples_for_ci=3),
    dict(min_samples_for_ci=3, bootstrap_samples=50),
    dict(gather_near_whiteboard=False, confidence_level=0.9,
         min_samples_for_ci=2)])
@pytest.mark.parametrize("paired", [False, True])
def test_metadata_analysis_matches_jax(kw, paired):
    """The per-hashtag table (means, CIs, counts), alone and as the A-B
    difference against a reference system: equal to the JAX package's.
    Bootstrap CIs draw from numpy's global generator, seeded alike."""
    wer, meta = wer_frames(1)
    ref = wer_frames(2)[0] if paired else None
    np.random.seed(3)
    want = jra.ResultsAnalyser(wer, meta, ref).metadata_analysis(**kw)
    np.random.seed(3)
    got = tra.ResultsAnalyser(wer, meta, ref).metadata_analysis(**kw)
    pd.testing.assert_frame_equal(got, want)
    assert got.loc["all_items", "len"] == (36 if kw.get("ci_over_sessions")
                                           else 12)


@pytest.mark.parametrize("bootstrap", [0, 200])
def test_confidence_interval_of_mean_matches_jax(bootstrap):
    data = np.random.RandomState(4).rand(25)
    np.random.seed(5)
    want = jra.calculate_confidence_interval_of_mean(data, 0.95, bootstrap)
    np.random.seed(5)
    got = tra.calculate_confidence_interval_of_mean(list(data), 0.95,
                                                    bootstrap)
    assert got == want and got[0] < data.mean() < got[1]


def test_plot_metadata_results_draws_both_panels():
    pytest.importorskip("matplotlib")
    wer, meta = wer_frames(1)
    df = tra.ResultsAnalyser(wer, meta).metadata_analysis(
        min_samples_for_ci=3)
    fig = tra.plot_metadata_results(df)
    assert len(fig.axes) == 2
    assert len(fig.axes[0].lines) + len(fig.axes[0].collections) > 0


def test_plot_utils_write_the_jax_files(tmp_path):
    """The three plots write the files the JAX package's write: the two
    copied plots byte for byte, the separation-method panel and its wav
    dumps (through each package's iSTFT) with the wavs within 1e-5 of
    full scale."""
    pytest.importorskip("matplotlib")
    rng = np.random.RandomState(6)
    F, T, S = 257, 40, 3
    masks = rng.rand(F, T, S).astype(np.float32)
    act_b = (rng.rand(T, S) > 0.5).astype(np.float32)
    act_f = (rng.rand(T, S) > 0.5).astype(np.float32)
    stft0 = (rng.randn(F, T) + 1j * rng.randn(F, T)).astype(np.complex64)
    mvdr = (rng.randn(F, T, S) + 1j * rng.randn(F, T, S)).astype(
        np.complex64)
    perm = [2, 0, 1]
    for pkg, cfg, engine in (
            (jplot, JCssCfg(), JCssEngine(*SC, JCssCfg())),
            (tplot, CssCfg(), CssEngine(PORT_SC, CssCfg()))):
        out = tmp_path / pkg.__name__.split(".")[0]
        out.mkdir()
        pkg.plot_stitched_masks(masks, act_b, act_f, cfg, "masks",
                                str(out / "masks.png"), 30, 3.0)
        pkg.plot_left_right_stitch(masks, masks[:, ::-1], perm, 10, cfg,
                                   str(out / "stitch.png"))
        assert pkg.plot_separation_methods(
            out / "sep", engine, stft0, {"spk_masks": masks}, mvdr,
            cfg) == str(out / "sep")
    jdir, tdir = tmp_path / "notsofar_tpu", tmp_path / "notsofar_tpu_torch"
    want = sorted(p.relative_to(jdir) for p in jdir.rglob("*") if p.is_file())
    assert want == sorted(p.relative_to(tdir) for p in tdir.rglob("*")
                          if p.is_file())
    assert len(want) == 3 + S
    for name in ("masks.png", "stitch.png"):
        assert (tdir / name).read_bytes() == (jdir / name).read_bytes()
    for j in range(S):
        _, w_want = wf.read(jdir / "sep" / f"mvdr_spk{j}.wav")
        _, w_got = wf.read(tdir / "sep" / f"mvdr_spk{j}.wav")
        assert w_got.shape == w_want.shape == ((T - 1) * 256 + 512,)
        np.testing.assert_allclose(w_got, w_want, rtol=0, atol=1e-5)


def test_trace_writes_a_chrome_trace(tmp_path):
    """profiling.trace around a small CPU op writes one Chrome trace file
    whose events name the op."""
    a = torch.randn(64, 64)
    with profiling.trace(str(tmp_path / "trace")):
        torch.matmul(a, a).sum()
    files = list((tmp_path / "trace").glob("*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    names = {e.get("name") for e in events}
    assert "aten::matmul" in names and len(events) > 3
