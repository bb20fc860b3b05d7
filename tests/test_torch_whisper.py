"""notsofar_tpu_torch's Whisper model, mel frontend, tokenizer and loaders
against the JAX package, on the CPU.

The model runs at kernel dims (dk=64, width 128): the same calls that
reach the Pallas kernels in the JAX package (encoder_mha at T=S=1500,
attn_step at T=1 cache steps) reach the port's kernel wrappers, which take
their plain PyTorch versions on CPU tensors. Weights come from the JAX
model's init through variables_from_jax; inputs are numpy arrays made from
a seed. f32 throughout.
"""
import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from notsofar_tpu.asr import mel as jmel
from notsofar_tpu.asr import tokenizer as jtok
from notsofar_tpu.models import whisper as jw
from notsofar_tpu_torch.asr import mel as tmel
from notsofar_tpu_torch.asr import tokenizer as ttok
from notsofar_tpu_torch.models import whisper as tw

REPO = Path(__file__).resolve().parent.parent

# width 128 with 2 heads: dk=64, the head geometry of every Whisper
# checkpoint, so both packages take their kernel paths
KDIMS_ARGS = (80, 1500, 128, 2, 1, 1864, 448, 128, 2, 2)


@pytest.fixture(autouse=True, scope="module")
def torch_threads():
    """The suite runs several pytest workers at once; torch's default of
    one intra-op thread per core in each of them oversubscribes the CPU.
    Two threads per module while it runs, then the old setting back."""
    n = torch.get_num_threads()
    torch.set_num_threads(min(n, 2))
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def pair():
    """(JAX model, JAX variables, port model) with identical f32 weights."""
    jm = jw.WhisperModel(jw.WhisperDims(*KDIMS_ARGS), dtype=jnp.float32)
    variables = jax.tree_util.tree_map(np.asarray,
                                       jm.init(jax.random.PRNGKey(3)))
    tm = tw.WhisperModel(tw.WhisperDims(*KDIMS_ARGS), device="cpu")
    tm.load_state_dict(tw.variables_from_jax(variables))
    return jm, variables, tm


def mini_tokenizers():
    """The byte-level fallback tokenizer of both packages (n_vocab 1864)."""
    return (jtok.WhisperTokenizer(None, 256, multilingual=True,
                                  num_languages=99),
            ttok.WhisperTokenizer(None, 256, multilingual=True,
                                  num_languages=99))


def test_log_mel_batch_matches_jax():
    """Batched mel with per-row valid frames: the dynamic-range clamp maxes
    over each row's own frames. Tolerance 1e-4 on the (log10 + 4) / 4
    scale (f32 DFT sums in another order)."""
    rng = np.random.RandomState(2)
    lens = [16000, 40000, 9999]
    L_max = max(lens) + jmel.N_SAMPLES
    batch = np.zeros((3, L_max), np.float32)
    for b, n in enumerate(lens):
        batch[b, :n] = rng.randn(n).astype(np.float32) * 0.1
    valid = np.asarray([(n + jmel.N_SAMPLES) // jmel.HOP_LENGTH
                        for n in lens], np.int32)
    want = np.asarray(jmel.log_mel_spectrogram_batch(
        jnp.asarray(batch), jnp.asarray(valid), n_mels=128))
    got = tmel.log_mel_spectrogram_batch(
        torch.from_numpy(batch), torch.from_numpy(valid), n_mels=128)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4)
    single = tmel.log_mel_spectrogram(torch.from_numpy(
        np.pad(batch[2, :lens[2]], (0, jmel.N_SAMPLES))), n_mels=128)
    np.testing.assert_allclose(got[2, :, :valid[2]].numpy(),
                               single.numpy(), atol=1e-5)


def test_encoder_matches_jax_through_encoder_mha(pair):
    """T = S = 1500 routes both encoders through encoder_mha (Pallas in
    interpret mode / the port's wrapper). Tolerance 2e-4 (f32; LayerNorm
    outputs of unit scale)."""
    jm, variables, tm = pair
    mel = np.random.RandomState(0).randn(1, 80, 3000).astype(np.float32)
    want = np.asarray(jm.encode(variables, jnp.asarray(mel)))
    got = tm.encode(torch.from_numpy(mel))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)


def test_encode_windows_slices_like_jax(pair):
    jm, variables, tm = pair
    mels = np.random.RandomState(1).randn(2, 80, 3400).astype(np.float32)
    seeks = [0, 400]
    want = np.asarray(jm.encode_windows(variables, jnp.asarray(mels),
                                        jnp.asarray(seeks)))
    got = tm.encode_windows(torch.from_numpy(mels), seeks)
    np.testing.assert_allclose(got.numpy(), want, atol=2e-4, rtol=2e-4)


def test_decoder_teacher_forced_matches_jax(pair):
    """Full-sequence decoder (causal mask, no cache), with and without
    per-row left pads. Tolerance 1e-4 on f32 logits."""
    jm, variables, tm = pair
    rng = np.random.RandomState(5)
    xa = rng.randn(2, 64, 128).astype(np.float32) * 0.3
    toks = rng.randint(0, 1000, (2, 7))
    for pads in (None, np.asarray([0, 3], np.int32)):
        want, _, _ = jm.decoder.apply(
            variables["decoder"], jnp.asarray(toks, jnp.int32),
            jnp.asarray(xa), 0,
            pad_lens=None if pads is None else jnp.asarray(pads))
        got, _, _ = tm.decoder(
            torch.from_numpy(toks), torch.from_numpy(xa), 0,
            pad_lens=None if pads is None else torch.from_numpy(pads))
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   atol=1e-4, rtol=1e-4)


def test_decoder_incremental_matches_jax_through_attn_step(pair):
    """Prefill 3 tokens, then T=1 cache steps (attn_step on both sides),
    with per-row pads and precomputed cross K/V; the port's in-place
    caches equal JAX's returned caches, and its step logits equal JAX's
    and the port's own teacher-forced logits. Tolerance 1e-4 (f32)."""
    jm, variables, tm = pair
    rng = np.random.RandomState(6)
    xa = rng.randn(2, 64, 128).astype(np.float32) * 0.3
    toks = rng.randint(0, 1000, (2, 7))
    pads = np.asarray([0, 2], np.int32)
    jpads, tpads = jnp.asarray(pads), torch.from_numpy(pads)
    jxa, txa = jnp.asarray(xa), torch.from_numpy(xa)
    jcross = jm.precompute_cross_kv(variables["decoder"], jxa)
    tcross = tm.precompute_cross_kv(txa)
    jc = jm.empty_kv_caches(2, cache_len=64)
    tc = tm.empty_kv_caches(2, cache_len=64)
    jl, jc, _ = jm.decoder.apply(variables["decoder"],
                                 jnp.asarray(toks[:, :3], jnp.int32), jxa,
                                 0, jc, cross_kvs=jcross, pad_lens=jpads)
    tl, tc, _ = tm.decoder(torch.from_numpy(toks[:, :3]), txa, 0, tc,
                           cross_kvs=tcross, pad_lens=tpads)
    j_out, t_out = [np.asarray(jl[:, -1])], [tl[:, -1].numpy()]
    for s in range(3, 7):
        jl, jc, _ = jm.decoder.apply(
            variables["decoder"], jnp.asarray(toks[:, s:s + 1], jnp.int32),
            jxa, s, jc, cross_kvs=jcross, pad_lens=jpads)
        tl, tc, _ = tm.decoder(torch.from_numpy(toks[:, s:s + 1]), txa, s,
                               tc, cross_kvs=tcross, pad_lens=tpads)
        j_out.append(np.asarray(jl[:, 0]))
        t_out.append(tl[:, 0].numpy())
    np.testing.assert_allclose(np.stack(t_out, 1), np.stack(j_out, 1),
                               atol=1e-4, rtol=1e-4)
    for (jk, jv), (tk_, tv) in zip(jc, tc):
        np.testing.assert_allclose(tk_.numpy(), np.asarray(jk), atol=1e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)
    full, _, _ = tm.decoder(torch.from_numpy(toks), txa, 0, pad_lens=tpads)
    np.testing.assert_allclose(np.stack(t_out, 1), full[:, 2:].numpy(),
                               atol=1e-4, rtol=1e-4)


def test_openai_checkpoint_loader_matches_jax(tmp_path, pair):
    """A checkpoint the test writes in openai-whisper's .pt layout loads
    into the same weights in both packages (the JAX tree through
    variables_from_jax)."""
    _, _, tm = pair
    sd = {k: v.clone() for k, v in tm.state_dict().items()
          if k != "encoder.positional_embedding"}
    path = tmp_path / "kernel_dims.pt"
    torch.save(dict(dims=dataclasses.asdict(tm.dims),
                    model_state_dict=sd), str(path))
    got, dims = tw.load_openai_whisper_checkpoint(path)
    assert dims == tm.dims
    jvars, jdims = jw.load_openai_whisper_checkpoint(path)
    assert dataclasses.asdict(jdims) == dataclasses.asdict(dims)
    bridged = tw.variables_from_jax(jvars)
    assert set(got) == set(bridged) == set(tm.state_dict())
    for k in got:
        torch.testing.assert_close(got[k].float(), bridged[k], rtol=0,
                                   atol=0, msg=k)
    m = tw.WhisperModel(dims, device="cpu")
    m.load_state_dict(got)


def test_tokenizer_copy_matches_jax():
    for name, n_vocab in (("large-v3", 51866), ("tiny.en", 51864),
                          ("tiny", 51865)):
        j = jtok.load_tokenizer(name, n_vocab)
        t = ttok.load_tokenizer(name, n_vocab)
        assert dataclasses.asdict(j.specials) == \
            dataclasses.asdict(t.specials)
        assert j.sot_sequence == t.sot_sequence
        ids = t.encode(" hello, world")
        assert ids == j.encode(" hello, world")
        assert t.split_to_word_tokens(ids) == j.split_to_word_tokens(ids)


def test_int8_decoder_is_a_later_slice():
    from notsofar_tpu_torch.asr.inference import load_whisper_model
    with pytest.raises(NotImplementedError, match="later slice"):
        tw.WhisperModel(tw.WhisperDims(*KDIMS_ARGS), device="cpu",
                        quant_decoder=True)
    with pytest.raises(NotImplementedError, match="later slice"):
        load_whisper_model("tiny", compute_dtype="int8", device="cpu")


def test_entry_points_raise_without_a_card():
    """Without device='cpu' the entry points ask for CUDA; with no card
    they raise instead of quietly running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    import pandas as pd
    from notsofar_tpu_torch.asr.inference import (WhisperAsrCfg,
                                                  asr_inference,
                                                  load_whisper_model)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tw.WhisperModel(tw.WhisperDims(*KDIMS_ARGS))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_whisper_model("tiny")
    session = pd.Series(dict(session_id="s", meeting_id="m",
                             sep_wav_file_names=[]))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        asr_inference("unused", session, WhisperAsrCfg(model_name="tiny"),
                      fetch_from_cache=False)


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_port_never_imports_jax_or_the_jax_package():
    """No module of notsofar_tpu_torch, nor chip_smoke.py, imports jax,
    flax or notsofar_tpu: statically, and in a fresh interpreter that
    imports every module of the port."""
    files = sorted((REPO / "notsofar_tpu_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py"]
    banned = ("jax", "jaxlib", "flax", "notsofar_tpu")
    for f in files:
        for mod in _imported_modules(f):
            assert mod.split(".")[0] not in banned, (f, mod)
    code = (
        "import importlib, pkgutil, sys\n"
        "import notsofar_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{banned!r})\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules "
        "if m.startswith('notsofar_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 41
