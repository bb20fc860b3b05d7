"""The f32 convolutions the port leaves to cuDNN run with its TF32 off
(utils.device.cudnn_f32), as the JAX package's f32 convs run in f32: the
CSS Conformer's depthwise conv and TitaNet's grouped-conv branch (the
80-channel prologue, the k = 1 epilogue), and the backward of a train
step. bf16 keeps the caller's setting. Each conv call records
torch.backends.cudnn.allow_tf32 as it runs, with the caller's at True
(PyTorch's default); the caller's setting comes back after each.
"""
import pytest
import torch

from notsofar_tpu_torch.models import conformer as tconf
from notsofar_tpu_torch.models import titanet as ttn
from notsofar_tpu_torch.training import config as tcfg
from notsofar_tpu_torch.training import train as ttrain
from tests.test_torch_training import make_batch, torch_batch, train_cfg


def spy_conv1d(monkeypatch):
    """Each F.conv1d call's allow_tf32, and at backward time the flag
    under which the gradient of its output arrives."""
    seen, back = [], []
    conv = torch.nn.functional.conv1d

    def spy(*a, **k):
        seen.append(torch.backends.cudnn.allow_tf32)
        out = conv(*a, **k)
        if out.requires_grad:
            out.register_hook(
                lambda g: back.append(torch.backends.cudnn.allow_tf32))
        return out
    monkeypatch.setattr(torch.nn.functional, "conv1d", spy)
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", True)
    return seen, back


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conformer_conv_runs_with_cudnn_tf32_off_in_f32(monkeypatch, dtype):
    seen, _ = spy_conv1d(monkeypatch)
    mod = tconf.ConvModule(128, 33, dtype)
    with torch.no_grad():
        for p in mod.parameters():
            p.normal_(0.0, 0.1)
    mod.train(False)
    out = mod(torch.randn(2, 40, 128, generator=torch.Generator()
                          .manual_seed(0)))
    assert out.shape == (2, 40, 128)
    assert seen == [dtype != torch.float32]
    assert torch.backends.cudnn.allow_tf32 is True


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels,kernel", [(80, 3), (256, 1)])
def test_titanet_grouped_conv_runs_with_cudnn_tf32_off_in_f32(
        monkeypatch, dtype, channels, kernel):
    """The grouped-conv branch of TitaNet's DepthwiseConv (channels not a
    multiple of 128, or k = 1; the others take depthwise_conv1d)."""
    seen, _ = spy_conv1d(monkeypatch)
    mod = ttn.DepthwiseConv(channels, kernel, dtype)
    with torch.no_grad():
        mod.weight.normal_(0.0, 0.1)
    out = mod(torch.randn(2, 30, channels))
    assert out.shape == (2, 30, channels)
    assert seen == [dtype != torch.float32]
    assert torch.backends.cudnn.allow_tf32 is True


def test_train_step_backward_runs_with_cudnn_tf32_off(monkeypatch):
    """A train step of the tiny f32 recipe: every conv's forward and the
    gradient of its output (its backward) run with TF32 off."""
    seen, back = spy_conv1d(monkeypatch)
    cfg = train_cfg(tcfg)
    model = ttrain.get_model(cfg, "cpu")
    state = ttrain.init_state(model, cfg)
    ttrain.make_train_step(model, cfg)[0](
        state, torch_batch(make_batch(3)), 1e-3, torch.Generator(),
        torch.tensor([1, 4, 0, 2]))
    n_blocks = cfg.conformer_css_cfg.nnet_conf.conformer_conf.num_blocks
    assert len(seen) == len(back) == n_blocks > 0
    assert not any(seen) and not any(back)
    assert torch.backends.cudnn.allow_tf32 is True
