"""The port's Conformer CSS model and weight bridge against the JAX package.

Each flax module is initialized, its parameters and statistics perturbed
(so norms and batch statistics are not identities), and the same tree
loaded into the port through variables_from_jax. f32 comparisons hold to
1e-5 relative (sums in another order); bf16 ones to 2e-2 relative (bf16
roundings at the same points, products summed in another order).
"""
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from notsofar_tpu.models import conformer as jc
from notsofar_tpu.models import css_wrapper as jw
from notsofar_tpu.models.convert import convert_css_state_dict as jconvert
from notsofar_tpu_torch.models import conformer as tc
from notsofar_tpu_torch.models import css_wrapper as tw
from notsofar_tpu_torch.models import convert as tconv

FIXTURE = Path(__file__).parent / "fixtures" / "css_tiny_trained"
KW = dict(attention_dim=32, attention_heads=4, linear_units=64, num_blocks=2,
          kernel_size=5, dropout_rate=0.0)
DTYPES = {"f32": (jnp.float32, torch.float32, 1e-5),
          "bf16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def perturb(tree, seed):
    """Every leaf plus seeded noise; variances stay positive."""
    rng = np.random.RandomState(seed)

    def f(path, x):
        x = np.asarray(x, np.float32)
        noise = rng.randn(*x.shape).astype(np.float32) * 0.1
        if path and getattr(path[-1], "key", None) == "var":
            return np.abs(x + noise) + 0.5
        return x + noise

    return jax.tree_util.tree_map_with_path(f, tree)


def numpy_tree(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def rel(a, b):
    a, b = (np.asarray(v) for v in (a, b))
    if not np.iscomplexobj(b):
        a, b = a.astype(np.float32), b.astype(np.float32)
    return np.abs(a - b).max() / np.abs(b).max()


def port_module(mod, variables):
    mod.load_state_dict(tconv.variables_from_jax(variables))
    return mod.eval().requires_grad_(False)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_conformer_modules_match_jax(dt):
    jdt, tdt, tol = DTYPES[dt]
    rng = np.random.RandomState(1)
    B, T, D = 2, 23, 32
    x = rng.randn(B, T, D).astype(np.float32)
    pos_k = rng.randn(T, T, D // 4).astype(np.float32)
    xj, xt = jnp.asarray(x), torch.from_numpy(x)
    cases = [
        (jc.FeedForward(D, 64, 0.0, jdt), (xj,), tc.FeedForward(D, 64, tdt),
         (xt,)),
        (jc.MultiHeadedAttention(4, D, 0.0, jdt), (xj, jnp.asarray(pos_k)),
         tc.MultiHeadedAttention(4, D, tdt), (xt, torch.from_numpy(pos_k))),
        (jc.MultiHeadedAttention(4, D, 0.0, jdt), (xj, None),
         tc.MultiHeadedAttention(4, D, tdt), (xt, None)),
        (jc.ConvModule(D, 5, 0.0, jdt), (xj,), tc.ConvModule(D, 5, tdt),
         (xt,)),
        (jc.EncoderLayer(jc.ConformerConfig(**KW), jdt),
         (xj, jnp.asarray(pos_k)),
         tc.EncoderLayer(tc.ConformerConfig(**KW), tdt),
         (xt, torch.from_numpy(pos_k))),
    ]
    for i, (jmod, jargs, tmod, targs) in enumerate(cases):
        variables = perturb(numpy_tree(jmod.init(jax.random.PRNGKey(i),
                                                 *jargs)), i)
        want = jmod.apply(variables, *jargs)
        got = port_module(tmod, variables)(*targs)
        assert str(got.dtype).split(".")[-1] == \
            jnp.dtype(want.dtype).name, (i, got.dtype, want.dtype)
        assert rel(got.float().numpy(), want) < tol, (i, rel(got.float(), want))


@pytest.mark.parametrize("dt", ["f32", "bf16"])
def test_conformer_css_masks_match_jax(dt):
    """ConformerCSS end to end, MC (1799-d input, 4 sources): masks
    [B, F, T, S+N] in f32. The bf16 tolerance is absolute on masks in
    [0, 1]."""
    jdt, tdt, tol = DTYPES[dt]
    cfg = jc.ConformerConfig(**KW)
    jmod = jc.ConformerCSS(conformer=cfg, dtype=jdt)
    rng = np.random.RandomState(2)
    f = rng.randn(2, 1799, 37).astype(np.float32)
    variables = perturb(numpy_tree(jmod.init(jax.random.PRNGKey(3),
                                             jnp.asarray(f))), 3)
    want = np.asarray(jmod.apply(variables, jnp.asarray(f)))
    tmod = port_module(tc.ConformerCSS(conformer=tc.ConformerConfig(**KW),
                                       dtype=tdt), variables)
    got = tmod(torch.from_numpy(f))
    assert got.dtype == torch.float32 and got.shape == want.shape == \
        (2, 257, 37, 4)
    assert np.abs(got.numpy() - want).max() < tol


def test_variables_from_jax_covers_a_live_init_tree():
    """A CssModel.init tree maps onto exactly the port's state dict keys
    and shapes (params, batch_stats and constants)."""
    jm = jw.CssModel(jw.ConformerCssConfig(
        nnet_conf=jw.NnetConfig(conformer_conf=jc.ConformerConfig(**KW))))
    sd = tconv.variables_from_jax(numpy_tree(jm.init(jax.random.PRNGKey(0))))
    tm = tw.CssModel(tw.ConformerCssConfig(
        nnet_conf=tw.NnetConfig(conformer_conf=tc.ConformerConfig(**KW))),
        device="cpu")
    want = {k: tuple(v.shape) for k, v in tm.module.state_dict().items()}
    assert {k: tuple(v.shape) for k, v in sd.items()} == want
    assert "encoder.layer_1.conv.bn.running_var" in sd
    assert "input_scale" in sd and "encoder.pos_emb" in sd


def test_msgpack_reader_matches_flax_on_the_trained_fixture():
    """The port's own decoder against flax.serialization on the committed
    native checkpoint: the same tree, bit for bit."""
    data = (FIXTURE / "params.msgpack").read_bytes()
    mine = tconv.read_flax_msgpack(data)
    theirs = serialization.msgpack_restore(data)
    flat_m = jax.tree_util.tree_leaves_with_path(mine)
    flat_t = jax.tree_util.tree_leaves_with_path(theirs)
    assert [p for p, _ in flat_m] == [p for p, _ in flat_t]
    for (_, a), (_, b) in zip(flat_m, flat_t):
        assert a.dtype == b.dtype and a.shape == b.shape
        np.testing.assert_array_equal(a, b)


def test_msgpack_reader_decodes_every_flax_leaf_kind():
    tree = {"a": np.arange(6, dtype=np.float32).reshape(2, 3),
            "b": {"c": np.float32(2.5), "d": np.zeros((0,), np.int32),
                  "e": 3, "f": -7, "g": 1.5, "h": "text", "i": None,
                  "j": True, "k": 2 + 3j, "l": 70000, "m": -40000}}
    got = tconv.read_flax_msgpack(serialization.msgpack_serialize(tree))
    np.testing.assert_array_equal(got["a"], tree["a"])
    assert got["b"]["c"] == np.float32(2.5)
    assert got["b"]["d"].shape == (0,) and got["b"]["d"].dtype == np.int32
    for k in "efghijklm":
        assert got["b"][k] == tree["b"][k]


def test_convert_css_state_dict_matches_the_jax_converter(tmp_path):
    """The reference torch layout -> the port's state dict equals the JAX
    converter's flax tree through variables_from_jax; a .pt file with the
    DDP 'module.' prefix loads to the same dict."""
    from tests.test_convert import synth_state_dict
    sd = synth_state_dict(np.random.RandomState(0))
    got = tconv.convert_css_state_dict(sd, num_blocks=2)
    want = tconv.variables_from_jax(jconvert(sd, num_blocks=2))
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k
    torch.save({"model": {f"module.{k}": torch.from_numpy(v)
                          for k, v in sd.items()}}, tmp_path / "m.pt")
    loaded = tconv.load_torch_checkpoint(tmp_path / "m.pt")
    assert loaded.keys() == sd.keys()
    for k in sd:
        np.testing.assert_array_equal(loaded[k], sd[k])
    # the converted weights drive the port's model (MC, 1799-d input)
    tm = tw.CssModel(tw.ConformerCssConfig(
        nnet_conf=tw.NnetConfig(conformer_conf=tc.ConformerConfig(**KW))),
        state_dict=got, device="cpu")
    m = tm.forward(torch.randn(1, 16000, 7) * 0.1)["spk_masks"]
    assert torch.isfinite(m).all() and m.min() >= 0 and m.max() <= 1


def test_css_model_interface_matches_jax():
    """stft / separate / forward / istft of CssModel on the same weights
    and audio, f32 (SC: no IPD, so no branch cut)."""
    cfg_j = jw.sc_css_config(jc.ConformerConfig(**KW))
    jm = jw.CssModel(cfg_j)
    jv = numpy_tree(jm.init(jax.random.PRNGKey(4)))
    tm = tw.CssModel(tw.sc_css_config(tc.ConformerConfig(**KW)),
                     state_dict=tconv.variables_from_jax(jv), device="cpu")
    rng = np.random.RandomState(5)
    mix = (rng.randn(2, 12000, 1) * 0.1).astype(np.float32)
    jr = jm.forward(jv, jnp.asarray(mix))
    tr = tm.forward(torch.from_numpy(mix))
    for k in ("spk_masks", "noise_masks"):
        assert tr[k].shape == jr[k].shape
        assert np.abs(tr[k].numpy() - np.asarray(jr[k])).max() < 1e-5
    c = tm.stft(torch.from_numpy(mix[..., 0]))
    assert rel(tm.istft(c).numpy(), jm.istft(jnp.asarray(c.numpy()))) < 1e-5
    mc = (rng.randn(1, 8000, 7) * 0.1).astype(np.float32)
    assert rel(tm.stft(torch.from_numpy(mc)).numpy(),
               jm.stft(jnp.asarray(mc))) < 1e-5
    lc = tw.large_conformer_config()
    assert (lc.attention_dim, lc.attention_heads, lc.num_blocks,
            lc.kernel_size, lc.linear_units) == (512, 8, 18, 33, 1024)
