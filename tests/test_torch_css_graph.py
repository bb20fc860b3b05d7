"""The CSS model's network as a CUDA graph (`CssModel.masks_graphed`,
which the CSS engine runs on a card) against the eager network: the same
masks bit for bit, at a small Conformer in float32 and bfloat16 and at
the full Conformer-large width in bfloat16 on one chunk of 32 windows,
over two inputs replayed through one graph. The `gpu` cases skip without a
card. This file imports nothing from tests/ (the card machine has an
installed package named `tests`)."""
import pytest
import torch

from notsofar_tpu_torch.models import conformer as tc
from notsofar_tpu_torch.models import css_wrapper as tw

SMALL = tc.ConformerConfig(attention_dim=32, attention_heads=4,
                           linear_units=64, num_blocks=2, kernel_size=5,
                           dropout_rate=0.0)


def _model(conf, dtype, device):
    return tw.CssModel(tw.ConformerCssConfig(
        nnet_conf=tw.NnetConfig(conformer_conf=conf)), dtype=dtype,
        device=device, seed=7)


def test_masks_graphed_runs_the_eval_network_only():
    model = _model(SMALL, torch.float32, "cpu").train(True)
    with pytest.raises(RuntimeError, match="eval"):
        model.masks_graphed(torch.zeros(1, 1799, 186))


@pytest.mark.gpu
@pytest.mark.parametrize("conf,dtype,batch", [
    (SMALL, torch.float32, 4), (SMALL, torch.bfloat16, 4),
    (tc.ConformerConfig(), torch.bfloat16, 32)])
def test_gpu_masks_graphed_equal_the_eager_network(conf, dtype, batch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    model = _model(conf, dtype, "cuda")
    g = torch.Generator(device="cuda").manual_seed(11)
    feats = [torch.randn(batch, 1799, 186, generator=g, device="cuda")
             for _ in range(2)]
    outs = [model.masks_graphed(f) for f in feats]
    assert len(model._graphs) == 1
    for f, got in zip(feats, outs):
        want = model.masks_from_feature(f)
        for k in ("spk_masks", "noise_masks"):
            assert torch.equal(got[k], want[k]), k
    # each call's masks are its own: the second replay left the first's
    assert not torch.equal(outs[0]["spk_masks"], outs[1]["spk_masks"])
