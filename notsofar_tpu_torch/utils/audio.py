"""Wav reading without soundfile/librosa.

Copy of ``read_wav_scaled`` from notsofar_tpu/utils/audio.py (the only
audio helper the ASR slice needs): scipy.io.wavfile, PCM scaled to
[-1, 1).
"""
from typing import Tuple

import numpy as np
import scipy.io.wavfile as wf


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
