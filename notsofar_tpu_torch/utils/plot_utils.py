"""Debug plotting for CSS inference intermediates.

Port of notsofar_tpu/utils/plot_utils.py (the NOTSOFAR baseline's
utils/plot_utils.py): stitched mask / activity panels, left-right stitch
alignment views, and separation-method comparisons with wav dumps. Inputs
are numpy arrays (the engine's side_info); matplotlib, imported only when
a plot is drawn, renders headlessly. The wav dumps go through the
engine's synthesis iSTFT on the engine's device.
"""
from pathlib import Path
from typing import Optional

import numpy as np
import torch

from notsofar_tpu_torch.utils.audio import write_wav


def _plt():
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    return plt


def plot_stitched_masks(mask_stitched: np.ndarray, activity_b: np.ndarray,
                        activity_final: np.ndarray, cfg,
                        title_str: Optional[str] = None,
                        out_filename: Optional[str] = None,
                        segment_frames: Optional[int] = None,
                        segment_size_sec: Optional[float] = None):
    """mask_stitched: [F, T, S]; activity_b/final: [T, S]."""
    plt = _plt()
    S = cfg.num_spks
    T = mask_stitched.shape[1]
    activity = mask_stitched.mean(axis=0)  # [T, S]
    fps = None
    if segment_frames is not None or segment_size_sec is not None:
        assert segment_frames is not None and segment_size_sec is not None
        fps = int(segment_frames / segment_size_sec)

    fig = plt.figure(figsize=(15, 5 * S * 2))
    for j in range(S):
        plt.subplot(2 * S, 1, 2 * j + 1)
        plt.imshow(mask_stitched[:, :, j], aspect="auto", origin="lower")
        plt.title(f"Speaker {j + 1} Mask")
        plt.ylabel("Frequency Bins")
        plt.xlim(0, T - 1)
        if fps is not None:
            ticks = range(0, T, fps // 2)
            plt.xticks(ticks, [t / fps for t in ticks])
        plt.subplot(2 * S, 1, 2 * j + 2)
        plt.plot(activity[:, j], label="mean mask")
        plt.plot(activity_b[:, j], label=f"thresh={cfg.activity_th}")
        plt.plot(activity_final[:, j],
                 label=f"dilate({cfg.activity_dilation_sec})->"
                       f"erode({cfg.activity_erosion_sec})")
        plt.title(f"Speaker {j + 1} Activity")
        plt.ylabel("Average Activity")
        plt.xlim(0, T - 1)
        plt.ylim(0, 1.05)
        plt.legend(loc="best")
    plt.suptitle(title_str or "Speaker Masks and Activities")
    if out_filename:
        plt.savefig(out_filename, bbox_inches="tight")
    plt.close(fig)
    return out_filename


def plot_left_right_stitch(left_input: np.ndarray, right_input: np.ndarray,
                           right_perm, overlap_frames: int, cfg,
                           out_filename: Optional[str] = None):
    """Visualize PIT alignment of two adjacent windows on their overlap.
    left/right: [F, T, S]."""
    plt = _plt()
    S = cfg.num_spks
    left = left_input[:, -overlap_frames:, :]
    right = right_input[:, :overlap_frames, :]
    fig, axes = plt.subplots(S, 3, figsize=(15, 4 * S))
    for j in range(S):
        axes[j, 0].imshow(left[:, :, j], aspect="auto", origin="lower")
        axes[j, 0].set_title(f"left spk{j}")
        axes[j, 1].imshow(right[:, :, j], aspect="auto", origin="lower")
        axes[j, 1].set_title(f"right spk{j} (raw)")
        axes[j, 2].imshow(right[:, :, int(right_perm[j])], aspect="auto",
                          origin="lower")
        axes[j, 2].set_title(f"right spk{right_perm[j]} (aligned)")
    if out_filename:
        plt.savefig(out_filename, bbox_inches="tight")
    plt.close(fig)
    return out_filename


def plot_separation_methods(out_dir, engine, mix_stft_ch0: np.ndarray,
                            masks: dict, mvdr_responses: Optional[np.ndarray],
                            cfg, fs: int = 16000):
    """Compare masking strategies on one segment and dump wavs for
    listening (the baseline's plot_utils.py:96-187)."""
    plt = _plt()
    out_dir = Path(out_dir)
    out_dir.mkdir(parents=True, exist_ok=True)
    spk = masks["spk_masks"]
    plots = {"mixture": np.abs(mix_stft_ch0)[..., None].repeat(spk.shape[-1], -1),
             "spk_masks": spk,
             "masked_ref_ch": np.abs(mix_stft_ch0[..., None] * spk)}
    if mvdr_responses is not None:
        plots["mvdr"] = np.abs(mvdr_responses)
        plots["masked_mvdr"] = np.abs(mvdr_responses * spk)
    S = spk.shape[-1]
    fig, axes = plt.subplots(len(plots), S, figsize=(5 * S, 4 * len(plots)))
    for r, (name, arr) in enumerate(plots.items()):
        for j in range(S):
            ax = axes[r, j] if len(plots) > 1 else axes[j]
            ax.imshow(np.log10(np.maximum(arr[:, :, j], 1e-8)),
                      aspect="auto", origin="lower")
            ax.set_title(f"{name} spk{j}")
    fig.savefig(out_dir / "separation_methods.png", bbox_inches="tight")
    plt.close(fig)
    # dump wavs for listening
    for name, stft_c in [("mvdr", mvdr_responses)]:
        if stft_c is None:
            continue
        for j in range(S):
            c = torch.as_tensor(np.ascontiguousarray(stft_c[None, :, :, j]),
                                dtype=torch.complex64, device=engine.device)
            wav = engine.model.extractor.istft_op.inverse(c)[0].cpu().numpy()
            write_wav(out_dir / f"{name}_spk{j}.wav", wav, fs)
    return str(out_dir)
