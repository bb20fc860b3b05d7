"""Wav I/O without soundfile/librosa.

Copies of ``read_wav``, ``read_wav_scaled`` and ``write_wav`` from
notsofar_tpu/utils/audio.py (the helpers the ASR and diarization slices
need): scipy.io.wavfile plus float32 PCM.
"""
import os
from typing import Tuple

import numpy as np
import scipy.io.wavfile as wf

MAX_INT16 = np.iinfo(np.int16).max


def read_wav(fname, normalize: bool = True, return_rate: bool = False):
    """Read a wav file; returns float32 samples (channels-first for MC).

    int16 PCM is divided by 32767 and int32 PCM by 2**31 - 1 when
    `normalize`; float files read as-is; multi-channel output is
    transposed to [C, N].
    """
    sr, samps = wf.read(fname)
    if samps.dtype == np.int16:
        samps = samps.astype(np.float32)
        if normalize:
            samps = samps / MAX_INT16
    elif samps.dtype == np.int32:
        samps = samps.astype(np.float32)
        if normalize:
            samps = samps / np.iinfo(np.int32).max
    elif samps.dtype in (np.float32, np.float64):
        samps = samps.astype(np.float32)
    else:
        raise ValueError(f"unsupported wav dtype: {samps.dtype}")
    if samps.ndim != 1:
        samps = np.transpose(samps)
    if return_rate:
        return sr, samps
    return samps


def read_wav_scaled(fname) -> Tuple[np.ndarray, int]:
    """Read a wav as float32 in [-1, 1] without channel transpose.

    Equivalent to ``soundfile.read(path, dtype='float32')``: float files
    read as-is, PCM scaled to [-1, 1).
    """
    sr, samps = wf.read(fname)
    if samps.dtype == np.int16:
        samps = samps.astype(np.float32) / 32768.0
    elif samps.dtype == np.int32:
        samps = samps.astype(np.float32) / 2147483648.0
    else:
        samps = samps.astype(np.float32)
    return samps, sr


def write_wav(fname, samps: np.ndarray, sr: int = 16000, max_norm: bool = True):
    """Write a mono wav as float32 PCM, optionally max-normalized to 0.99
    (avoids overflow), creating the directory if needed."""
    samps = np.asarray(samps)
    assert samps.ndim == 1, "write_wav expects mono"
    if max_norm:
        samps = samps * 0.99 / (np.max(np.abs(samps)) + 1e-7)
    dir_name = os.path.dirname(str(fname))
    if dir_name:
        os.makedirs(dir_name, exist_ok=True)
    wf.write(str(fname), sr, samps.astype(np.float32))
