"""The benchmark's input generator. A traffic file (``workloads/*.json``)
holds only parameters; every input is drawn here from the run's seed, so
the same seed gives the same inputs, and every seed the same sizes.

* ``talkers``: 16 kHz talkers with a speech-like envelope (voiced
  harmonic bursts at a syllable rate, pauses, a noise floor);
* ``streams``: a draw of single-channel talkers, as the separated CSS
  streams that ASR reads (the training partition places talkers on a
  microphone array: drivers/css_train.py);
* ``sub_seed``: a seed for one draw, from the run's seed and the draw's
  tags.
"""
import hashlib
from typing import Dict

import torch

SAMPLE_RATE = 16000


def sub_seed(seed: int, *tags) -> int:
    """A 63-bit seed from the run's seed and tags (any size of seed)."""
    h = hashlib.sha256(repr((int(seed),) + tags).encode()).digest()
    return int.from_bytes(h[:8], "little") >> 1


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(seed)


def talkers(n: int, samples: int, seed: int, device,
            syllable_hz: float = 4.0, speech_share: float = 0.7
            ) -> torch.Tensor:
    """[n, samples] float32: each row a talker, voiced harmonic bursts
    (a fundamental of 90-250 Hz and 12 harmonics falling off at 1/k) under
    a syllable-rate envelope, silent a (1 - speech_share) share of
    one-second blocks."""
    g = _generator(seed, device)
    t = torch.arange(samples, device=device, dtype=torch.float32) \
        / SAMPLE_RATE
    f0 = 90.0 + 160.0 * torch.rand(n, 1, generator=g, device=device)
    # slow pitch drift: f0 * (1 + 0.1 sin(2 pi 0.3 t + phase))
    phase = 6.2832 * torch.rand(n, 1, generator=g, device=device)
    inst = f0 * (1.0 + 0.1 * torch.sin(1.885 * t[None] + phase))
    theta = torch.cumsum(inst / SAMPLE_RATE, dim=1) * 6.2832
    voiced = torch.zeros(n, samples, device=device)
    for k in range(1, 13):
        voiced += torch.sin(k * theta) / k
    env_phase = 6.2832 * torch.rand(n, 1, generator=g, device=device)
    env = torch.sin(6.2832 * syllable_hz * t[None] + env_phase).clamp_min(0)
    blocks = -(-samples // SAMPLE_RATE)
    on = (torch.rand(n, blocks, generator=g, device=device)
          < speech_share).float()
    on = on.repeat_interleave(SAMPLE_RATE, dim=1)[:, :samples]
    noise = torch.randn(n, samples, generator=g, device=device)
    return 0.05 * voiced * env * on + 0.002 * noise


def streams(p: Dict, seed: int, draw: int, device) -> torch.Tensor:
    """Draw `draw` of a stream mix: [p['streams'], p['stream_seconds'] x
    16 kHz] float32 on `device`."""
    samples = int(p["stream_seconds"] * SAMPLE_RATE)
    return talkers(int(p["streams"]), samples, sub_seed(seed, "streams",
                                                        draw), device)
