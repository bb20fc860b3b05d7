"""The port's CSS engine and entry points against the JAX package.

The engine runs on the CPU with the weights of the JAX engine test
(tests/test_css_engine.py: the default MC extractor with raw IPD v1, and
an SC model), loaded through variables_from_jax. Both engines get the same
float audio and quantize it to the same int16; activity gating must agree
exactly, stitched masks within rtol 5e-3, and the streams are checked as
the JAX test checks them: against the float64 reference oracle where the
reference's own precision class (a complex64 MVDR solve) is stable, and
for boundedness where it is not.
"""
from pathlib import Path

import jax
import numpy as np
import pandas as pd
import pytest
import torch

from notsofar_tpu.css.engine import CssCfg as JCssCfg
from notsofar_tpu.css.engine import CssEngine as JCssEngine
from notsofar_tpu_torch.css import inference as tinf
from notsofar_tpu_torch.css.engine import (CssCfg, CssEngine,
                                           build_weight_matrix,
                                           calc_segment_weight)
from notsofar_tpu_torch.models import conformer as tc
from notsofar_tpu_torch.models import css_wrapper as tw
from notsofar_tpu_torch.models.convert import variables_from_jax
from tests.test_css_engine import (FS, MC, SC, TINY, quantize_like_engine,
                                   reference_oracle)
from tools.make_e2e_accuracy_fixture import make_utterance, si_snr_db

FIXTURE = Path(__file__).parent / "fixtures" / "css_tiny_trained"
TINY_T = tc.ConformerConfig(attention_dim=TINY.attention_dim,
                            attention_heads=TINY.attention_heads,
                            linear_units=TINY.linear_units,
                            num_blocks=TINY.num_blocks,
                            kernel_size=TINY.kernel_size, dropout_rate=0.0)


def port_model(jax_pair, mc: bool) -> tw.CssModel:
    _, variables = jax_pair
    cfg = tw.ConformerCssConfig(nnet_conf=tw.NnetConfig(conformer_conf=TINY_T)) \
        if mc else tw.sc_css_config(TINY_T)
    return tw.CssModel(cfg, state_dict=variables_from_jax(
        jax.tree_util.tree_map(np.asarray, variables)), device="cpu")


PORT_MC, PORT_SC = port_model(MC, True), port_model(SC, False)


def engine_cfgs(mode):
    kw = dict(seg_bucket_multiple=4, seg_chunk=2)
    if mode != "sc":
        kw["mc_mvdr"] = mode == "mc_mvdr"
    if mode == "mc_nomvdr":
        kw["mc_mask_floor_db"] = -np.inf
    return JCssCfg(**kw), CssCfg(**kw)


def test_segment_weights_match_jax():
    from notsofar_tpu.css import engine as je
    for first, last in ((True, False), (False, True), (False, False)):
        np.testing.assert_array_equal(
            calc_segment_weight(186, 9, 18, first, last),
            je.calc_segment_weight(186, 9, 18, first, last))
    np.testing.assert_array_equal(build_weight_matrix(5, 8, 186, 9, 18),
                                  je.build_weight_matrix(5, 8, 186, 9, 18))


@pytest.mark.parametrize("use_pallas_scm", [False, True])
@pytest.mark.parametrize("mode", ["sc", "mc_nomvdr", "mc_mvdr"])
def test_engine_matches_jax_engine_and_oracle(mode, use_pallas_scm):
    """mc_mvdr with use_pallas_scm takes the masked-SCM kernel wrapper
    (its plain version on the CPU); sc and mc_nomvdr run no MVDR, so the
    flag must change nothing there."""
    rng = np.random.RandomState(5)
    n = int(7.3 * FS)                   # ~4 segments + a ragged tail
    jax_pair, port = (SC, PORT_SC) if mode == "sc" else (MC, PORT_MC)
    mix = (rng.randn(1, n, 1 if mode == "sc" else 7) * 0.1).astype(np.float32)
    jcfg, tcfg = engine_cfgs(mode)
    tcfg.use_pallas_scm = use_pallas_scm
    wavs, side = CssEngine(port, tcfg).separate_and_stitch(mix, FS)
    jwavs, jside = JCssEngine(*jax_pair, jcfg).separate_and_stitch(mix, FS)
    assert len(wavs) == 3 and side["num_segments"] == jside["num_segments"]
    np.testing.assert_array_equal(side["activity_final"],
                                  jside["activity_final"])
    np.testing.assert_allclose(side["mask_stitched"], jside["mask_stitched"],
                               rtol=5e-3, atol=5e-4)

    mix_q = quantize_like_engine(mix)
    owavs, omask, oact = reference_oracle(mix_q, *jax_pair, jcfg)
    np.testing.assert_array_equal(side["activity_final"], oact)
    np.testing.assert_allclose(side["mask_stitched"], omask, rtol=5e-3,
                               atol=5e-4)
    if mode == "mc_mvdr":
        owavs32, _, _ = reference_oracle(mix_q, *jax_pair, jcfg,
                                         mvdr_dtype=np.float32)
    for s in range(3):
        m = min(len(wavs[s]), owavs.shape[1])
        scale = max(np.abs(owavs[s, :m]).max(), 1e-6)
        d = np.abs(wavs[s][:m] - owavs[s, :m]) / scale
        if mode == "mc_mvdr" and \
                np.abs(owavs32[s, :m] - owavs[s, :m]).max() / scale >= 1e-3:
            assert np.isfinite(wavs[s]).all()     # unstable in f32 itself
            assert np.abs(wavs[s][:m]).max() < 50 * scale
        else:
            assert d.max() < 2e-2, (s, d.max())


def test_short_session_single_segment():
    rng = np.random.RandomState(6)
    mix = (rng.randn(1, FS, 1) * 0.1).astype(np.float32)  # 1 s < a segment
    wavs, side = CssEngine(PORT_SC, CssCfg(seg_bucket_multiple=1)) \
        .separate_and_stitch(mix, FS)
    assert len(wavs) == 3 and side["num_segments"] == 1
    assert all(np.isfinite(w).all() for w in wavs)


def test_batched_sessions_match_single():
    """Three sessions of different lengths in one pass equal three single
    calls (2e-4, the JAX test's tolerance); the lazy host list and the
    device outputs agree with the eager list."""
    rng = np.random.RandomState(9)
    mixes = [(rng.randn(1, int((4 + i) * FS), 1) * 0.1).astype(np.float32)
             for i in range(3)]
    engine = CssEngine(PORT_SC, CssCfg(seg_bucket_multiple=4, seg_chunk=2))
    singles = [engine.separate_and_stitch(m, FS, return_side_info=False)[0]
               for m in mixes]
    batched = engine.separate_sessions_batch(mixes, FS)
    lazy, (wav_dev, scales_dev, n_reals) = engine.separate_sessions_batch(
        mixes, FS, return_device=True, defer_host=True)
    assert len(batched) == len(lazy) == 3
    assert wav_dev.dtype == torch.int16 and wav_dev.shape[:2] == (3, 3)
    for s_wavs, b_wavs, l_wavs, n in zip(singles, batched, lazy, n_reals):
        for sw, bw, lw in zip(s_wavs, b_wavs, l_wavs):
            assert len(bw) == len(lw) == n
            np.testing.assert_array_equal(bw, lw)
            k = min(len(sw), len(bw))
            np.testing.assert_allclose(sw[:k], bw[:k], atol=2e-4)


def test_separate_uploaded_lazy_matches_jax():
    """separate_uploaded_lazy against the JAX method on the tiny SC model,
    two sessions in one pass: real sample counts equal, scales within 1e-5
    relative, the int16 codes within one step, the dequantized streams
    within 2e-4 (f32 sums in another order on both sides). The streams
    stay on the device until the lazy list is first read."""
    rng = np.random.RandomState(12)
    mixes = [(rng.randn(1, int((4 + 2 * i) * FS), 1) * 0.1).astype(np.float32)
             for i in range(2)]
    jcfg, tcfg = engine_cfgs("sc")
    je, te = JCssEngine(*SC, jcfg), CssEngine(PORT_SC, tcfg)
    jlazy, (jwav, jscales, jn) = je.separate_uploaded_lazy(
        je.upload_sessions(je.prepare_sessions(mixes, FS)))
    lazy, (wav, scales, n) = te.separate_uploaded_lazy(
        te.upload_sessions(te.prepare_sessions(mixes, FS)))
    assert lazy._host is None and wav.device == te.device
    assert n == jn and len(lazy) == len(jlazy) == 2
    np.testing.assert_allclose(scales.numpy(), np.asarray(jscales),
                               rtol=1e-5)
    assert np.abs(wav.numpy().astype(np.int32)
                  - np.asarray(jwav).astype(np.int32)).max() <= 1
    for got, want in zip(lazy, jlazy):
        for g, w in zip(got, want):
            assert g.shape == w.shape
            np.testing.assert_allclose(g, w, rtol=0, atol=2e-4)


def test_trained_sc_fixture_separates_through_the_port():
    """The committed trained SC model, loaded from its native msgpack
    checkpoint: best-stream SI-SNR improvement above 8 dB on held-out
    mixtures, as tests/test_e2e_accuracy.py requires of the JAX
    package."""
    model, train_cfg = tinf.load_css_model(FIXTURE, device="cpu")
    assert train_cfg.conformer_css_cfg.nnet_conf.in_features == 257
    rng = np.random.RandomState(20260820)
    for _ in range(3):
        mixture, direct, _ = make_utterance(rng)
        mix0 = torch.from_numpy(mixture[:, 0])
        stft_c = model.stft(mix0[None])
        masks = model.separate(stft_c)
        all_masks = torch.cat([masks["spk_masks"], masks["noise_masks"]],
                              -1)[0]
        streams = [model.istft(stft_c * all_masks[..., k])[0].numpy()
                   for k in range(all_masks.shape[-1])]
        for s in (0, 1):
            ref = direct[:, 0, s]
            if np.dot(ref, ref) < 1e-8:
                continue
            n = len(streams[0])
            base = si_snr_db(mixture[:n, 0], ref[:n])
            best = max(si_snr_db(st, ref[:len(st)]) for st in streams)
            assert best - base > 8.0, (s, base, best)


def write_mc_session(root: Path, name: str, seconds: float, seed: int):
    from notsofar_tpu_torch.utils.audio import write_wav
    rng = np.random.RandomState(seed)
    files = []
    for m in range(7):
        p = root / name / f"mic{m}.wav"
        write_wav(p, (rng.randn(int(seconds * FS)) * 0.1).astype(np.float32),
                  FS, max_norm=False)
        files.append(str(p))
    return dict(session_id=name, is_mc=True, wav_file_names=files)


def test_css_inference_and_prepass_write_the_same_layout(tmp_path):
    """A tiny MC model saved in the JAX package's native format; the
    port's css_batch_prepass (two sessions, one pass) and css_inference
    (serial, no cache) write css_inference/<session>/sep_stream{0,1,2}.wav
    and input_mixture.wav, and the serial streams equal the prepass's.
    A fetch_from_cache call returns the prepass files."""
    from notsofar_tpu.css.inference import save_css_model
    from notsofar_tpu.training.config import (ConformerCfgM,
                                              ConformerCssCfgM, NnetCfgM,
                                              TrainCfg)
    from notsofar_tpu_torch.utils.audio import read_wav_scaled
    models = tmp_path / "models"
    train_cfg = TrainCfg(conformer_css_cfg=ConformerCssCfgM(
        nnet_conf=NnetCfgM(conformer_conf=ConformerCfgM(
            attention_dim=32, attention_heads=4, linear_units=64,
            num_blocks=2, kernel_size=5, dropout_rate=0.0))))
    save_css_model(models / "notsofar/conformer1.0/mc", MC[1], train_cfg)
    sessions = pd.DataFrame([write_mc_session(tmp_path / "audio", f"s{i}",
                                              4.0 + i, i) for i in range(2)])
    cfg = CssCfg(seg_bucket_multiple=4, seg_chunk=4, batch_sessions=2,
                 use_pallas_scm=True)
    out_b, out_s = tmp_path / "batch", tmp_path / "serial"
    tinf.css_batch_prepass(str(out_b), str(models), sessions, cfg,
                           fetch_from_cache=False, device="cpu")
    row = sessions.iloc[0]
    res = tinf.css_inference(str(out_s), str(models), row, cfg,
                             fetch_from_cache=False, device="cpu")
    names = ["input_mixture.wav"] + [f"sep_stream{k}.wav" for k in range(3)]
    for out in (out_b / "css_inference" / "s0", out_b / "css_inference" / "s1",
                out_s / "css_inference" / "s0"):
        assert sorted(p.name for p in out.iterdir()) == names
    assert res.sep_wav_file_names == [
        str(out_s / "css_inference" / "s0" / f"sep_stream{k}.wav")
        for k in range(3)]
    for k in range(3):
        a, _ = read_wav_scaled(out_b / "css_inference/s0" / f"sep_stream{k}.wav")
        b, _ = read_wav_scaled(res.sep_wav_file_names[k])
        np.testing.assert_allclose(a, b, atol=2e-4)
    cached = tinf.css_inference(str(out_b), str(models), row, cfg,
                                fetch_from_cache=True, device="cpu")
    assert cached.sep_wav_file_names == [
        str(out_b / "css_inference" / "s0" / f"sep_stream{k}.wav")
        for k in range(3)]
    # the port loads the JAX package's native checkpoint to the same
    # weights, and a reference .pt beside the same yaml to the converted
    model, _ = tinf.load_css_model(models / "notsofar/conformer1.0/mc",
                                   device="cpu")
    want = variables_from_jax(jax.tree_util.tree_map(np.asarray, MC[1]))
    for k, v in model.module.state_dict().items():
        assert torch.equal(v, want[k]), k
    from tests.test_convert import synth_state_dict
    from notsofar_tpu_torch.models.convert import convert_css_state_dict
    pt_dir = tmp_path / "pt_model"
    pt_dir.mkdir()
    (pt_dir / "config.yaml").write_text(
        (models / "notsofar/conformer1.0/mc/config.yaml").read_text())
    sd = synth_state_dict(np.random.RandomState(1))
    torch.save({f"module.{k}": torch.from_numpy(v) for k, v in sd.items()},
               pt_dir / "model.pt")
    model, _ = tinf.load_css_model(pt_dir, device="cpu")
    want = convert_css_state_dict(sd, num_blocks=2)
    for k, v in model.module.state_dict().items():
        assert torch.equal(v, want[k]), k


def test_separate_cli_writes_streams(tmp_path):
    from notsofar_tpu_torch.css import separate_cli
    from notsofar_tpu_torch.utils.audio import write_wav
    rng = np.random.RandomState(0)
    write_wav(tmp_path / "mix.wav", (rng.randn(2 * FS) * 0.1
                                     ).astype(np.float32), FS)
    (tmp_path / "wav.scp").write_text(f"a/b {tmp_path / 'mix.wav'}\n")
    separate_cli.main(["--model", str(FIXTURE), "--input",
                       str(tmp_path / "mix.wav"), "--out-dir",
                       str(tmp_path / "out"), "--device", "cpu"])
    separate_cli.main(["--model", str(FIXTURE), "--scp",
                       str(tmp_path / "wav.scp"), "--out-dir",
                       str(tmp_path / "out"), "--device", "cpu"])
    assert sorted(p.name for p in (tmp_path / "out").iterdir()) == sorted(
        [f"mix_spk{i}.wav" for i in range(3)]
        + [f"a_b_spk{i}.wav" for i in range(3)])


def test_entry_points_default_to_the_card():
    """Without device="cpu" the port asks for cuda, and raises here."""
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        tinf.load_css_model(FIXTURE)
    with pytest.raises(RuntimeError, match="CUDA"):
        tw.CssModel(tw.sc_css_config(TINY_T))
