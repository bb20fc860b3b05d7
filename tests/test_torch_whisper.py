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


@pytest.mark.parametrize("pos_offset", [0, 5])
def test_decode_logits_matches_jax(pair, pos_offset):
    """WhisperModel.decode_logits (teacher-forced logits from pos_offset)
    against the JAX decode_logits on the same weights: f32 logits within
    1e-4."""
    jm, variables, tm = pair
    rng = np.random.RandomState(11 + pos_offset)
    xa = rng.randn(2, 64, 128).astype(np.float32) * 0.3
    toks = rng.randint(0, 1000, (2, 6))
    want = np.asarray(jm.decode_logits(variables, jnp.asarray(toks, jnp.int32),
                                       jnp.asarray(xa), pos_offset))
    got = tm.decode_logits(torch.from_numpy(toks), torch.from_numpy(xa),
                           pos_offset)
    assert got.dtype == torch.float32 and got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("prefix", ["", "model."])
def test_convert_hf_whisper_state_dict_matches_jax(prefix):
    """A Hugging Face Whisper state dict (WhisperModel, or with the
    WhisperForConditionalGeneration 'model.' prefix and its tied
    proj_out) through the port's converter equals the JAX converter's
    tree through variables_from_jax, bit for bit, and loads strictly."""
    transformers = pytest.importorskip("transformers")
    torch.manual_seed(0)
    dims = tw.WhisperDims(*KDIMS_ARGS)
    hf = transformers.WhisperModel(transformers.WhisperConfig(
        vocab_size=dims.n_vocab, num_mel_bins=dims.n_mels,
        encoder_layers=dims.n_audio_layer,
        encoder_attention_heads=dims.n_audio_head,
        decoder_layers=dims.n_text_layer,
        decoder_attention_heads=dims.n_text_head, d_model=dims.n_text_state,
        encoder_ffn_dim=4 * dims.n_text_state,
        decoder_ffn_dim=4 * dims.n_text_state,
        max_source_positions=dims.n_audio_ctx,
        max_target_positions=dims.n_text_ctx, pad_token_id=0))
    sd = {prefix + k: v for k, v in hf.state_dict().items()}
    if prefix:
        sd["proj_out.weight"] = sd["model.decoder.embed_tokens.weight"]
    got = tw.convert_hf_whisper_state_dict(sd, dims)
    want = tw.variables_from_jax(jw.convert_hf_whisper_state_dict(
        {k: v.numpy() for k, v in sd.items()}, jw.WhisperDims(*KDIMS_ARGS)))
    assert set(got) == set(want)
    for k in got:
        torch.testing.assert_close(got[k], want[k], rtol=0, atol=0, msg=k)
    tw.WhisperModel(dims, device="cpu").load_state_dict(got)


def test_pad_or_trim_matches_jax():
    rng = np.random.RandomState(4)
    for shape in ((1000,), (2, 3, 700)):
        x = rng.randn(*shape).astype(np.float32)
        for length in (500, 700, 1200):
            want = jmel.pad_or_trim(x, length)
            got = tmel.pad_or_trim(torch.from_numpy(x), length)
            np.testing.assert_array_equal(got.numpy(), want)
    assert tmel.pad_or_trim(torch.zeros(5)).shape == (tmel.N_SAMPLES,)


@pytest.mark.parametrize("pos_as", ["int", "tensor"])
def test_decoder_incremental_matches_jax_through_attn_step(pair, pos_as):
    """Prefill 3 tokens, then T=1 cache steps (attn_step on both sides),
    with per-row pads and precomputed cross K/V; the port's in-place
    caches equal JAX's returned caches, and its step logits equal JAX's
    and the port's own teacher-forced logits. pos_offset as an int, or as
    a 0-d tensor (the CUDA graph's form, equal to the int form bit for
    bit). Tolerance 1e-4 (f32)."""
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
        pos = torch.tensor(s) if pos_as == "tensor" else s
        if pos_as == "tensor":
            # the int form on copies of the caches gives the same bits
            ic = [(k_.clone(), v_.clone()) for k_, v_ in tc]
            il, _, _ = tm.decoder(torch.from_numpy(toks[:, s:s + 1]), txa, s,
                                  ic, cross_kvs=tcross, pad_lens=tpads)
        tl, tc, _ = tm.decoder(torch.from_numpy(toks[:, s:s + 1]), txa, pos,
                               tc, cross_kvs=tcross, pad_lens=tpads)
        if pos_as == "tensor":
            assert torch.equal(tl, il)
            assert all(torch.equal(a, b) for a, b in zip(tc[0], ic[0]))
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


@pytest.mark.parametrize("pos_as", ["int", "tensor"])
def test_decoder_split_cache_steps_match_jax(pair, pos_as):
    """The beam path's split cache: a 3-token prompt prefilled at 2
    streams, then T=1 steps of 2 beams a stream (attn_step_split with a
    random ancestry, the beams folded into the cross-attention queries) on
    both sides; pos_offset as an int or as a 0-d tensor (equal bit for
    bit). Step logits and the generated caches within 1e-4 / 1e-5 (f32)."""
    jm, variables, tm = pair
    rng = np.random.RandomState(12)
    B, K, P, G, steps = 2, 2, 3, 8, 4
    xa = rng.randn(B, 64, 128).astype(np.float32) * 0.3
    prompt = rng.randint(0, 1000, (B, P))
    toks = rng.randint(0, 1000, (B * K, steps))
    anc = rng.randint(0, K, (B, K, G)).astype(np.int32)
    pads = np.asarray([0, 1], np.int32)
    pad_k = np.repeat(pads, K)
    jxa, txa = jnp.asarray(xa), torch.from_numpy(xa)
    jcross = jm.precompute_cross_kv(variables["decoder"], jxa)
    tcross = tm.precompute_cross_kv(txa)
    _, jp, _ = jm.decoder.apply(
        variables["decoder"], jnp.asarray(prompt, jnp.int32), jxa, 0,
        jm.empty_kv_caches(B, cache_len=P), cross_kvs=jcross,
        pad_lens=jnp.asarray(pads))
    _, tp, _ = tm.decoder(torch.from_numpy(prompt), txa, 0,
                          tm.empty_kv_caches(B, cache_len=P),
                          cross_kvs=tcross, pad_lens=torch.from_numpy(pads))
    D = KDIMS_ARGS[7]
    jg = [(jnp.zeros((B * K, G, D)), jnp.zeros((B * K, G, D)))
          for _ in tp]
    tg = [(torch.zeros(B * K, G, D), torch.zeros(B * K, G, D)) for _ in tp]
    tanc = torch.zeros(B, K, G, dtype=torch.int32)
    for s in range(steps):
        anc[:, :, s] = np.arange(K)
        tanc.copy_(torch.from_numpy(anc))
        jsplit = [(kp, vp, kg, vg, jnp.asarray(anc))
                  for (kp, vp), (kg, vg) in zip(jp, jg)]
        jl, jsplit, _ = jm.decoder.apply(
            variables["decoder"], jnp.asarray(toks[:, s:s + 1], jnp.int32),
            jxa, P + s, jsplit, cross_kvs=jcross,
            pad_lens=jnp.asarray(pad_k))
        jg = [(c[2], c[3]) for c in jsplit]
        tsplit = [(kp, vp, kg, vg, tanc) for (kp, vp), (kg, vg)
                  in zip(tp, tg)]
        if pos_as == "tensor":
            isplit = [(kp, vp, kg.clone(), vg.clone(), tanc)
                      for kp, vp, kg, vg, _ in tsplit]
            il, _, _ = tm.decoder(torch.from_numpy(toks[:, s:s + 1]), txa,
                                  P + s, isplit, cross_kvs=tcross,
                                  pad_lens=torch.from_numpy(pad_k))
        pos = torch.tensor(P + s) if pos_as == "tensor" else P + s
        tl, _, _ = tm.decoder(torch.from_numpy(toks[:, s:s + 1]), txa, pos,
                              tsplit, cross_kvs=tcross,
                              pad_lens=torch.from_numpy(pad_k))
        if pos_as == "tensor":
            assert torch.equal(tl, il)
            assert torch.equal(tg[0][0], isplit[0][2])
        np.testing.assert_allclose(tl[:, 0].numpy(), np.asarray(jl[:, 0]),
                                   atol=1e-4, rtol=1e-4)
    for (jk, jv), (tk_, tv) in zip(jg, tg):
        np.testing.assert_allclose(tk_.numpy(), np.asarray(jk), atol=1e-5)
        np.testing.assert_allclose(tv.numpy(), np.asarray(jv), atol=1e-5)


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


def to_bf16_tree(variables):
    """The JAX package's bf16 cast of a float tree (asr/inference.py: every
    f32 leaf to bf16, before quantization)."""
    return jax.tree_util.tree_map(
        lambda x: np.asarray(jnp.asarray(x, jnp.bfloat16))
        if x.dtype == np.float32 else x, variables)


def int8_pair(variables, dtype):
    """(JAX int8 model, its quantized variables, port int8 model) from the
    same float variables, in compute dtype f32 or bf16 (bf16: the float
    tree is cast to bf16 first, as the serving loader does)."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    src = variables if dtype == "f32" else to_bf16_tree(variables)
    qv = jw.quantize_whisper_decoder(src)
    jm = jw.WhisperModel(jw.WhisperDims(*KDIMS_ARGS), dtype=jdt,
                         quant_decoder=True)
    tm = tw.WhisperModel(tw.WhisperDims(*KDIMS_ARGS), dtype=tdt,
                         device="cpu", quant_decoder=True)
    tm.load_state_dict(tw.variables_from_jax(qv))
    return jm, qv, tm


def test_quantize_whisper_decoder_matches_jax(pair):
    """Both routes to the port's int8 state_dict -- the JAX package's
    quantized tree through variables_from_jax, and the port's
    quantize_whisper_decoder on the bridged float tree -- give the same
    int8 codes and f32 scales, bit for bit, from f32 and from bf16
    weights; everything else (encoder, layer norms, biases, positions)
    is the float tree's."""
    _, variables, _ = pair
    for src in (variables, to_bf16_tree(variables)):
        via_jax = tw.variables_from_jax(jw.quantize_whisper_decoder(src))
        via_port = tw.quantize_whisper_decoder(tw.variables_from_jax(src))
        assert set(via_jax) == set(via_port)
        n_int8 = 0
        for k in via_jax:
            assert via_jax[k].dtype == via_port[k].dtype, k
            assert torch.equal(via_jax[k], via_port[k]), k
            n_int8 += via_jax[k].dtype == torch.int8
        # 2 blocks x (8 attention + 2 mlp matrices) + the embedding
        assert n_int8 == 21
        assert via_port["decoder.token_embedding.scale"].dtype == \
            torch.float32


def test_quantize_cross_kv_matches_jax():
    """Per-(row, channel) int8 cross-attention memory: codes equal to the
    JAX package's, scales within one f32 ulp, S = 1500 zero-padded to
    1504, s_valid 1500."""
    rng = np.random.RandomState(9)
    kvs = [(rng.randn(2, 1500, 128).astype(np.float32) * s,
            rng.randn(2, 1500, 128).astype(np.float32))
           for s in (0.5, 3.0)]
    kvs[1][0][:, :, 5] = 0.0                   # an all-zero channel: 1e-6
    want = jw.WhisperModel.quantize_cross_kv(
        [(jnp.asarray(k), jnp.asarray(v)) for k, v in kvs])
    got = tw.WhisperModel.quantize_cross_kv(
        [(torch.from_numpy(k), torch.from_numpy(v)) for k, v in kvs])
    for w, g in zip(want, got):
        assert g[4] == w[4] == 1500
        for i in (0, 2):
            assert g[i].dtype == torch.int8 and g[i].shape == (2, 1504, 128)
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(w[i]))
            assert not g[i][:, 1500:].any()
        for i in (1, 3):
            assert g[i].shape == (2, 1, 128)
            np.testing.assert_allclose(g[i].numpy(), np.asarray(w[i]),
                                       rtol=2.0 ** -23, atol=0)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_quant_dense_matches_flax(dtype):
    """QuantDense against flax QuantDense on the same int8 kernel, scale
    and bias: f32 within 1e-6 relative (sums in another order); bf16 -- x
    @ w8, * s and + b each rounded to bf16 on both sides -- within one
    bf16 ulp (2**-8 relative to the binade) of each output."""
    rng = np.random.RandomState(2)
    x = rng.randn(3, 5, 96).astype(np.float32)
    k8 = rng.randint(-127, 128, (96, 40)).astype(np.int8)
    sc = (rng.rand(40).astype(np.float32) + 0.1) * 0.01
    bias = rng.randn(40).astype(np.float32) * 0.1
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dtype]
    want = np.asarray(jw.QuantDense(40, dtype=jdt).apply(
        {"params": {"kernel": k8, "scale": sc, "bias": bias}},
        jnp.asarray(x)).astype(jnp.float32))
    dense = tw.QuantDense(96, 40)
    dense.load_state_dict({"weight": torch.from_numpy(k8.T.copy()),
                           "scale": torch.from_numpy(sc),
                           "bias": torch.from_numpy(bias)})
    dense.dtype = tdt
    with torch.no_grad():
        got = dense(torch.from_numpy(x))
    assert got.dtype == tdt
    got = got.float().numpy()
    if dtype == "f32":
        np.testing.assert_allclose(got, want, rtol=1e-6,
                                   atol=1e-6 * np.abs(want).max())
    else:
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30)))
                      - 7)
        assert (np.abs(got - want) <= ulp).all()


@pytest.mark.parametrize("dtype,tol", [("f32", 1e-5), ("bf16", 2e-2)])
def test_int8_decoder_teacher_forced_matches_jax(pair, dtype, tol):
    """The int8 decoder (f32 residual stream, int8 embedding rows, int8
    logits matrix) against the JAX int8 decoder on the same int8 weights,
    teacher-forced with and without left pads. Tolerance relative to the
    largest |logit|: 1e-5 in f32 (sums in another order), 2e-2 in bf16
    (bf16 roundings of products summed in another order)."""
    _, variables, _ = pair
    jm, qv, tm = int8_pair(variables, dtype)
    rng = np.random.RandomState(5)
    xa = rng.randn(2, 64, 128).astype(np.float32) * 0.3
    toks = rng.randint(0, 1000, (2, 7))
    for pads in (None, np.asarray([0, 3], np.int32)):
        want, _, _ = jm.decoder.apply(
            qv["decoder"], jnp.asarray(toks, jnp.int32), jnp.asarray(xa), 0,
            pad_lens=None if pads is None else jnp.asarray(pads))
        got, _, _ = tm.decoder(
            torch.from_numpy(toks), torch.from_numpy(xa), 0,
            pad_lens=None if pads is None else torch.from_numpy(pads))
        want = np.asarray(want)
        assert got.dtype == torch.float32
        err = np.abs(got.numpy() - want).max() / np.abs(want).max()
        assert err <= tol, err


@pytest.mark.parametrize("dtype,tol", [("f32", 1e-5), ("bf16", 2e-2)])
def test_cross_kv_quant_parity(pair, dtype, tol):
    """The int8 decoder through the int8 cross-attention memory: a 12-token
    prefill (Tq > 8: the dequantized einsum with the padding masked), then
    T = 1 cache steps (xattn_int8 in interpret mode / the port's wrapper);
    step logits relative to the largest |logit| within 1e-5 (f32) and
    2e-2 (bf16) of the JAX package's, and the memory's int8 codes equal."""
    _, variables, _ = pair
    jm, qv, tm = int8_pair(variables, dtype)
    rng = np.random.RandomState(21)
    xa = rng.randn(2, 1500, 128).astype(np.float32) * 0.3
    toks = rng.randint(0, 1000, (2, 16))
    jxa, txa = jnp.asarray(xa), torch.from_numpy(xa)
    jcross = jm.quantize_cross_kv(jm.precompute_cross_kv(qv["decoder"], jxa))
    tcross = tm.quantize_cross_kv(tm.precompute_cross_kv(txa))
    if dtype == "f32":
        for jc, tc in zip(jcross, tcross):
            np.testing.assert_array_equal(tc[0].numpy(), np.asarray(jc[0]))
            np.testing.assert_array_equal(tc[2].numpy(), np.asarray(jc[2]))
    jc = jm.empty_kv_caches(2, cache_len=64)
    tc = tm.empty_kv_caches(2, cache_len=64)
    jl, jc, _ = jm.decoder.apply(qv["decoder"],
                                 jnp.asarray(toks[:, :12], jnp.int32), jxa,
                                 0, jc, cross_kvs=jcross)
    tl, tc, _ = tm.decoder(torch.from_numpy(toks[:, :12]), txa, 0, tc,
                           cross_kvs=tcross)
    j_out, t_out = [np.asarray(jl)], [tl.numpy()]
    for s in range(12, 16):
        jl, jc, _ = jm.decoder.apply(
            qv["decoder"], jnp.asarray(toks[:, s:s + 1], jnp.int32), jxa, s,
            jc, cross_kvs=jcross)
        tl, tc, _ = tm.decoder(torch.from_numpy(toks[:, s:s + 1]), txa, s,
                               tc, cross_kvs=tcross)
        j_out.append(np.asarray(jl))
        t_out.append(tl.numpy())
    want, got = np.concatenate(j_out, 1), np.concatenate(t_out, 1)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def test_decode_kernel_gates():
    """uses_xattn_step takes the float (k, v) memory at a folded query
    length <= 8 (beams folded into it), never the int8 5-tuple;
    uses_decode_gemv takes up to DECODE_GEMV_MAX_ROWS rows (>= 64: the
    pipeline's 48-row int8 steps) against int8 or bf16 weights, never f32."""
    from notsofar_tpu_torch.ops import kernels as tk
    kv = (torch.empty(3, 1500, 128), torch.empty(3, 1500, 128))
    kv8 = (torch.empty(3, 1504, 128, dtype=torch.int8),) + (None,) * 3 + \
        (1500,)
    assert tw.uses_xattn_step(3, 1, kv) and tw.uses_xattn_step(15, 1, kv)
    assert tw.uses_xattn_step(3, 8, kv) and not tw.uses_xattn_step(3, 9, kv)
    assert not tw.uses_xattn_step(27, 1, kv)          # 9 beams folded
    assert not tw.uses_xattn_step(3, 1, kv8) and tw.uses_xattn_int8(3, 1, kv8)
    assert tk.DECODE_GEMV_MAX_ROWS >= 64
    for dt in (torch.int8, torch.bfloat16):
        assert tk.uses_decode_gemv(48, dt)
        assert tk.uses_decode_gemv(tk.DECODE_GEMV_MAX_ROWS, dt)
        assert not tk.uses_decode_gemv(tk.DECODE_GEMV_MAX_ROWS + 1, dt)
    assert not tk.uses_decode_gemv(3, torch.float32)


def counting(monkeypatch, name):
    """Count the calls of models.whisper's kernel wrapper `name` (the plain
    path counts no LAUNCHES on the CPU)."""
    calls = []
    real = getattr(tw, name)

    def wrapper(*args, **kwargs):
        calls.append(1)
        return real(*args, **kwargs)
    monkeypatch.setattr(tw, name, wrapper)
    return calls


@pytest.mark.parametrize("kind", ["f32", "bf16", "int8"])
def test_decode_step_calls_xattn_step_and_decode_gemv(pair, monkeypatch,
                                                      kind):
    """One single-token decode step of a small model on the CPU, after a
    3-token prefill, counted at the wrappers: the f32 model calls
    xattn_step once a layer and no decode_gemv (f32 weights stay
    matmuls); the bf16 and int8 models run the fused step, decode_qkv once
    a layer and decode_gemv 5 times a layer plus once (the out
    projections, the cross-attention's query, fc1, fc2, the logits), 6L + 1
    launches of the decode_gemv kernel, and xattn_step (bf16) or
    xattn_int8 (int8) for the cross-attention. DECODER_CALLS counts the
    step under each kernel it reaches and decode_gemv_per_call gives its
    launches; at large-v3 (32 layers) that is 193 for both. The 9-row
    prefill runs layer by layer through decode_gemv (8L + 1, counted under
    decode_gemv_layerwise); a 72-row prefill reaches neither."""
    _, variables, tm = pair
    if kind == "int8":
        _, _, m = int8_pair(variables, "bf16")
    elif kind == "bf16":
        m = tw.WhisperModel(tw.WhisperDims(*KDIMS_ARGS), dtype=torch.bfloat16,
                            device="cpu")
        m.load_state_dict(tm.state_dict())
    else:
        m = tm
    L = m.dims.n_text_layer
    rng = np.random.RandomState(4)
    xa = torch.from_numpy(rng.randn(6, 1500, 128).astype(np.float32) * 0.3)
    cross = m.precompute_cross_kv(xa)
    if kind == "int8":
        cross = m.quantize_cross_kv(cross)
    toks = torch.from_numpy(rng.randint(0, 1000, (6, 12)))
    caches = m.empty_kv_caches(6, cache_len=64)
    step = counting(monkeypatch, "xattn_step")
    gemv = counting(monkeypatch, "decode_gemv")
    qkv = counting(monkeypatch, "decode_qkv")
    tw.reset_decoder_calls()
    with torch.no_grad():
        m.decoder(toks, xa, 0, caches, cross_kvs=cross)       # 72 rows
        assert (len(step), len(gemv), len(qkv)) == (0, 0, 0)
        assert all(n == 0 for n in tw.DECODER_CALLS.values())
        m.decoder(toks[:3, :3], xa[:3], 0, m.empty_kv_caches(3, cache_len=64),
                  cross_kvs=[tuple(x[:3] if torch.is_tensor(x) else x
                                   for x in c) for c in cross])
        assert len(gemv) + len(qkv) == (0 if kind == "f32" else 8 * L + 1)
        assert tw.DECODER_CALLS["decode_gemv_layerwise"] == int(kind != "f32")
        if kind != "f32":
            assert m.decoder.decode_gemv_per_call(fused=False) == len(gemv)
        tw.reset_decoder_calls()
        del step[:], gemv[:], qkv[:]
        m.decoder(toks[:, 3:4], xa, torch.tensor(3), caches, cross_kvs=cross)
    want = {"f32": (L, 0, 0), "bf16": (L, 5 * L + 1, L),
            "int8": (0, 5 * L + 1, L)}[kind]
    assert (len(step), len(gemv), len(qkv)) == want
    assert tw.DECODER_CALLS == {"xattn_int8": int(kind == "int8"),
                                "xattn_step": int(kind != "int8"),
                                "decode_gemv": int(kind != "f32"),
                                "decode_gemv_layerwise": 0}
    if kind != "f32":
        assert m.decoder.decode_gemv_per_call() == len(gemv) + len(qkv)
    with torch.device("meta"):
        large = tw.WHISPER_DIMS["large-v3"]
        assert tw.TextDecoder(large, quant=True).decode_gemv_per_call() == 193
        assert tw.TextDecoder(large).decode_gemv_per_call() == 193
        assert tw.TextDecoder(large).decode_gemv_per_call(False) == 257


@pytest.mark.parametrize("kind", ["bf16", "int8", "int8_f32"])
@pytest.mark.parametrize("cache", ["unified", "split"])
def test_fused_decode_step_equals_the_layerwise_step(pair, monkeypatch,
                                                     kind, cache):
    """A single-token step of a small decoder on the CPU through the fused
    blocks (ResidualBlock.decode_step: the layer norms in the GEMVs'
    prologues, the one q/k/v launch writing the cache, GELU and the
    residual adds in the epilogues) gives the same logits and caches, bit
    for bit, as the same step with TextDecoder.fused_step forced off (every
    block's forward, layer by layer). Layer norms with seeded parameters;
    the unified cache with per-row pads, or the split beam cache (3 beams,
    per-stream pads, ancestry)."""
    _, variables, tm = pair
    if kind == "bf16":
        m = tw.WhisperModel(tw.WhisperDims(*KDIMS_ARGS), dtype=torch.bfloat16,
                            device="cpu")
        m.load_state_dict(tm.state_dict())
    else:
        _, _, m = int8_pair(variables, "f32" if kind == "int8_f32" else "bf16")
    rng = np.random.RandomState(8)
    with torch.no_grad():
        for name, prm in m.decoder.named_parameters():
            if "ln" in name:
                prm.add_(torch.from_numpy(rng.randn(*prm.shape).astype(
                    np.float32) * 0.1).to(prm.dtype))
    Bs, beams = 2, 3 if cache == "split" else 1
    B = Bs * beams
    xa = torch.from_numpy(rng.randn(Bs, 1500, 128).astype(np.float32) * 0.3)
    cross = m.precompute_cross_kv(xa)
    if kind != "bf16":
        cross = m.quantize_cross_kv(cross)
    toks = torch.from_numpy(rng.randint(0, 1000, (B, 5)))
    with torch.no_grad():
        if cache == "unified":
            caches = m.empty_kv_caches(B, cache_len=32)
            pads = torch.tensor([0, 2], dtype=torch.int32)
            m.decoder(toks[:, :4], xa, 0, caches, cross_kvs=cross,
                      pad_lens=pads)
        else:
            prompt = m.empty_kv_caches(Bs, cache_len=4)
            m.decoder(toks[:Bs, :4], xa, 0, prompt, cross_kvs=cross)
            gen = m.empty_kv_caches(B, cache_len=8)
            for kg, vg in gen:
                kg.normal_(generator=torch.Generator().manual_seed(1))
                vg.normal_(generator=torch.Generator().manual_seed(2))
            anc = torch.from_numpy(rng.randint(0, beams, (Bs, beams, 8))
                                   .astype(np.int32))
            caches = [(kp, vp, kg, vg, anc) for (kp, vp), (kg, vg)
                      in zip(prompt, gen)]
            pads = torch.tensor([1, 1, 1, 0, 0, 0], dtype=torch.int32)
        runs = []
        for fused in (True, False):
            if not fused:
                monkeypatch.setattr(tw.TextDecoder, "fused_step",
                                    lambda self, *a: False)
            cs = [tuple(t.clone() for t in c) for c in caches]
            pos = torch.tensor(6) if cache == "split" else torch.tensor(4)
            assert m.decoder.fused_step(B, 1, cs, cross) == fused
            logits, new, _ = m.decoder(toks[:, 4:5], xa, pos, cs,
                                       cross_kvs=cross, pad_lens=pads)
            runs.append((logits, new))
    (lf, cf), (ll, cl) = runs
    assert lf.dtype == torch.float32 and torch.isfinite(lf).all()
    assert torch.equal(lf, ll)
    for a, b in zip(cf, cl):
        assert all(torch.equal(x, y) for x, y in zip(a, b))


def test_int8_load_path():
    """load_whisper_model(compute_dtype='int8') gives the int8 decoder:
    int8 kernels with f32 scales, an int8 embedding with f32 row scales,
    bf16 biases and layer norms, and a bf16 encoder."""
    from notsofar_tpu_torch.asr.inference import load_whisper_model
    model, _, _ = load_whisper_model("tiny", compute_dtype="int8",
                                     device="cpu")
    assert model.quant_decoder and model.dtype == torch.bfloat16
    q = model.decoder.blocks[0].attn.query
    assert q.weight.dtype == torch.int8 and q.scale.dtype == torch.float32
    assert q.bias.dtype == torch.bfloat16 and q.dtype == torch.bfloat16
    emb = model.decoder.token_embedding
    assert emb.weight.dtype == torch.int8 and emb.scale.dtype == torch.float32
    assert model.encoder.conv1.weight.dtype == torch.bfloat16
    assert model.decoder.blocks[0].mlp[0].weight.dtype == torch.int8


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
    """No module of notsofar_tpu_torch, nor chip_smoke.py,
    run_inference_gpu.py or run_training_css_gpu.py, imports jax, flax,
    notsofar_tpu or the repository's tools/: statically, and in a fresh
    interpreter that imports every module of the port (the training
    stack's and the real-weight validator's among them)."""
    files = sorted((REPO / "notsofar_tpu_torch").rglob("*.py")) + \
        [REPO / "chip_smoke.py", REPO / "run_inference_gpu.py",
         REPO / "run_training_css_gpu.py"]
    assert {"train", "losses", "augmentations", "schedulers", "dataset",
            "parity"} <= {f.stem for f in files
                          if f.parent.name == "training"}
    assert {"validate_real_weights", "marblenet_oracle", "results_analysis",
            "plot_utils"} <= {f.stem for f in files}
    banned = ("jax", "jaxlib", "flax", "notsofar_tpu", "tools")
    for f in files:
        for mod in _imported_modules(f):
            assert mod.split(".")[0] not in banned, (f, mod)
    code = (
        "import importlib, pkgutil, sys\n"
        "import notsofar_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "import chip_smoke, run_inference_gpu, run_training_css_gpu\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{banned!r})\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules "
        "if m.startswith('notsofar_tpu_torch')]))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 70
