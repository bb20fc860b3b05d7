"""The time-based diarization models of notsofar_tpu_torch on the card
against the same seeded weights on the CPU (`gpu`-marked; they skip
without a card): MarbleNet at the shipped topology and the telephonic
MSDD, in f32 with TF32 off, within 1e-4. This file imports nothing from
tests/ (the card machine has an installed package named `tests`)."""
import numpy as np
import pytest
import torch

from notsofar_tpu_torch.models import marblenet as tm
from notsofar_tpu_torch.models import msdd as tmsdd

TOL = 1e-4


@pytest.fixture
def cuda_f32():
    """The card, with TF32 off for its cuBLAS matmuls and cuDNN convs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    tf32 = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    yield torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32 = tf32


@pytest.mark.gpu
def test_gpu_marblenet_matches_the_cpu(cuda_f32):
    """DEFAULT_BLOCKS, three rows of 3, 1.9 and 0.8 s: frame
    probabilities within 1e-4 of the CPU's."""
    cpu = tm.FrameVAD(device="cpu", seed=3)
    gpu = tm.FrameVAD(state_dict=cpu.module.state_dict(), device=cuda_f32)
    rng = np.random.RandomState(7)
    wavs = (rng.randn(3, 48000) * 0.1).astype(np.float32)
    lengths = np.asarray([48000, 30000, 12345])
    got = gpu.frame_probs(wavs, lengths)
    assert np.abs(got - cpu.frame_probs(wavs, lengths)).max() <= TOL


@pytest.mark.gpu
def test_gpu_msdd_matches_the_cpu(cuda_f32):
    """K 5, D 192, hidden 256, 3 LSTM layers, 16 channels, S 2, three
    chunks of 256 segments: probabilities within 1e-4 of the CPU's."""
    cfg = tmsdd.MSDDConfig()
    cpu = tmsdd.OverlapDecoder(cfg, device="cpu", seed=1)
    gpu = tmsdd.OverlapDecoder(cfg, cpu.module.state_dict(), device=cuda_f32)
    rng = np.random.RandomState(5)
    e = rng.randn(3, 256, cfg.n_scales, cfg.emb_dim).astype(np.float32)
    a = rng.randn(3, cfg.n_scales, cfg.emb_dim, 2).astype(np.float32)
    assert np.abs(gpu.refine(e, a) - cpu.refine(e, a)).max() <= TOL
