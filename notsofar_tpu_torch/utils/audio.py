"""Wav I/O without soundfile/librosa.

Copies of ``read_wav``, ``read_wav_scaled``, ``write_wav``,
``load_session_audio``, ``parse_scp`` and ``ScpWaveReader`` from
notsofar_tpu/utils/audio.py (the helpers the ASR, diarization and CSS
slices need): scipy.io.wavfile plus float32 PCM.
"""
import os
from typing import List, Tuple

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


def load_session_audio(wav_file_names: List, is_mc: bool, num_mics: int = 7
                       ) -> Tuple[np.ndarray, int]:
    """Load session audio as [Batch=1, Nsamples, Channels] float32: MC
    sessions give one wav per mic (7 files, cut to the shortest), SC
    sessions one mono file."""
    if is_mc:
        assert len(wav_file_names) == num_mics, f"expecting {num_mics} microphones"
        audio, srs = zip(*[read_wav_scaled(w) for w in wav_file_names])
        n = min(a.shape[0] for a in audio)
        mix = np.stack([a[:n] for a in audio], axis=-1)[np.newaxis, ...]
        sr = srs[0]
    else:
        assert len(wav_file_names) == 1
        mix, sr = read_wav_scaled(wav_file_names[0])
        assert mix.ndim == 1
        mix = mix[np.newaxis, :, np.newaxis]
    return mix.astype(np.float32), sr


def parse_scp(scp_path, value_processor=lambda x: x, num_tokens: int = 2,
              restrict: bool = True) -> dict:
    """Parse a Kaldi script (.scp) file into an ordered {key: value} dict:
    whitespace-split lines, the first token is the key, duplicated keys
    are an error; num_tokens >= 2 enforces exact arity, num_tokens < 0
    passes the token list through value_processor."""
    out = {}
    with open(scp_path, "r") as f:
        for line, raw in enumerate(f):
            toks = raw.strip().split()
            if (num_tokens >= 2 and len(toks) != num_tokens) or \
                    (restrict and len(toks) < 2):
                raise RuntimeError(
                    f"For {scp_path}, format error in line[{line:d}]: {raw}")
            if num_tokens == 2:
                key, value = toks
            else:
                key, value = toks[0], toks[1:]
            if key in out:
                raise ValueError(f"Duplicated key '{key}' exists in "
                                 f"{scp_path}")
            out[key] = value_processor(value)
    return out


class ScpWaveReader:
    """Sequential/random reader over a Kaldi-style wav.scp ('key
    /path/to/wav' per line): iteration yields (key, samples) with samples
    float32, channels-first for MC, scaled to [-1, 1) when normalize=True;
    a configured sample rate is enforced on every read."""

    def __init__(self, wav_scp, sr: int = 16000, normalize: bool = True):
        self.index_dict = parse_scp(wav_scp)
        self.sr = sr
        self.normalize = normalize

    def _load(self, key):
        sr, samps = read_wav(self.index_dict[key],
                             normalize=self.normalize, return_rate=True)
        if self.sr is not None and sr != self.sr:
            raise RuntimeError(f"Sample rate mismatch: {sr:d} vs "
                               f"{self.sr:d}")
        return samps

    def __len__(self):
        return len(self.index_dict)

    def __contains__(self, key):
        return key in self.index_dict

    def __getitem__(self, key):
        if key not in self.index_dict:
            raise KeyError(f"Missing utterance {key}!")
        return self._load(key)

    def __iter__(self):
        for key in self.index_dict:
            yield key, self._load(key)
