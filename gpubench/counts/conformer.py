"""Operations of the CSS Conformer's forward pass and training step, from
its shapes.

A frozen copy of the port's ``utils/flops.py::conformer_css_flops``,
corrected against ``models/conformer.py``: a block has two macaron FFNs
(each two Linears), and its convolution module's pointwise parts are
scalar taps (elementwise), so its only matmul work is the depthwise
convolution. Each multiply-add counts 2. A training step is the forward
pass and its backward pass (twice the forward's matmul work), plus the
STFTs of the input features and the loss targets, which need no
backward.
"""
from typing import Dict


def forward_flops(c: Dict, T: int) -> float:
    """One row of T frames through the network (features to masks)."""
    d, u, k = c["attention_dim"], c["linear_units"], c["kernel_size"]
    embed = 2 * T * c["in_features"] * d
    ffns = 2 * (2 * T * d * u * 2)
    attn = 4 * 2 * T * d * d + 3 * 2 * T * T * d
    conv = 2 * T * d * k
    head = 2 * T * d * c["num_bins"] * (c["num_spks"] + c["num_nois"])
    return embed + c["num_blocks"] * (ffns + attn + conv) + head


def stft_flops(T: int, channels: int, frame: int = 512,
               bins: int = 257) -> float:
    """A real STFT of `channels` signals of T frames, as a DFT product."""
    return channels * T * bins * frame * 2 * 2


def train_step_flops(c: Dict, batch: int, T: int, mics: int = 7) -> float:
    """One optimizer step of `batch` rows: forward and backward of the
    network, the features' STFT of every mic and the loss's STFTs of the
    reference mic's mixture, speakers and noise."""
    loss_channels = 1 + c["num_spks"] + c["num_nois"]
    return batch * (3 * forward_flops(c, T)
                    + stft_flops(T, mics + loss_channels))
