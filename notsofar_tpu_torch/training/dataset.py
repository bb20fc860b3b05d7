"""Simulated training dataset: random-access byte-seek segment reader.

Copy of notsofar_tpu/training/dataset.py (numpy only; the port imports
nothing from the JAX package). The on-disk format is the reference's:

* a partition is either a .tar archive or a flat directory with a .map
  index ({utterance_id: num_samples} JSON);
* each utterance stores one raw file per column ({uid}.{column}) of int16
  rows plus a {uid}.json metadata record with dtype/shape/row_size and
  per-column *_scale factors;
* columns: mixture [T,7], gt_spk_direct_early_echoes [T,7,3],
  gt_spk_reverb [T,7,3], gt_noise [T,7], gt_spk_activity_scores [T,3] i8;
* invariant: mixture ~= sum_spk(direct) + sum_spk(reverb) + noise.

Segments are read with a seek + short read (no full-utterance load), and
SegmentSplitter reproduces the reference's per-epoch jittered cover
(overlap in [min,max], force-align probability). Batches come out as
numpy dicts; an optional thread pool reads a batch's segments in
parallel. The native reader is the port's native/segread.cpp, built into
native/build/libsegread.so.
"""
import glob
import json
import math
import tarfile
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path
from typing import Callable, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
from numpy import ndarray

ALL_COLUMNS = ["mixture", "gt_spk_activity_scores",
               "gt_spk_direct_early_echoes", "gt_spk_reverb", "gt_noise"]
SCALED_COLUMNS = ["mixture", "gt_spk_direct_early_echoes", "gt_spk_reverb",
                  "gt_noise"]

# optional native reader (open+seek+read+descale in one GIL-free call)
_SEGREAD = None
_SEGREAD_TRIED = False


def _load_segread():
    global _SEGREAD, _SEGREAD_TRIED
    if _SEGREAD_TRIED:
        return _SEGREAD
    _SEGREAD_TRIED = True
    import ctypes
    import os
    import subprocess
    native_dir = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "native")
    so = os.path.join(native_dir, "build", "libsegread.so")
    # always invoke make: no-op when fresh, rebuild when segread.cpp changed
    # (a stale .so must never shadow source edits)
    try:
        subprocess.run(["make", "-C", native_dir, "build/libsegread.so"],
                       check=True, capture_output=True)
    except Exception:
        if not os.path.exists(so):
            return None
    try:
        lib = ctypes.CDLL(so)
        lib.read_scaled_segment_i16.restype = ctypes.c_int
        lib.read_scaled_segment_i16.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64,
            ctypes.c_double, ctypes.POINTER(ctypes.c_float)]
        _SEGREAD = lib
    except OSError:
        _SEGREAD = None
    return _SEGREAD


class SegmentSplitter:
    """Random segment cover of an utterance (simulated_dataset.py:275-398)."""

    def __init__(self, min_overlap: int = 50, max_overlap: int = 150,
                 pr_force_align: float = 0.5,
                 desired_segm_len: Union[int, Tuple[int, int]] = 300):
        assert 0.0 <= pr_force_align <= 1.0
        assert 0 <= min_overlap <= max_overlap
        self.min_overlap = min_overlap
        self.max_overlap = max_overlap
        self.pr_force_align = pr_force_align
        self.desired_segm_len = desired_segm_len

    def interval_cover(self, utt_lengths: ndarray, segm_len: int):
        assert segm_len > self.max_overlap
        steps = np.maximum(0, np.floor(
            (utt_lengths - self.max_overlap) / (segm_len - self.max_overlap)
        ).astype(int))
        overlap = np.zeros_like(steps)
        uncovered = utt_lengths.copy()
        eq1, gt1 = steps == 1, steps > 1
        ov_full = np.ceil((steps[gt1] * segm_len - utt_lengths[gt1])
                          / np.maximum(steps[gt1] - 1, 1)).astype(int)
        ov = np.maximum(ov_full, self.min_overlap)
        assert np.all(ov <= self.max_overlap)
        cover = segm_len + (segm_len - ov) * (steps[gt1] - 1)
        overlap[gt1] = ov
        uncovered[gt1] = utt_lengths[gt1] - cover
        uncovered[eq1] = utt_lengths[eq1] - segm_len
        assert np.all(uncovered >= 0)
        return steps, overlap, uncovered

    def __call__(self, utt_length: int,
                 seed: Optional[Tuple[int, int]] = (39565, 0)
                 ) -> Tuple[List[int], int]:
        if seed is None:
            seed = (39565, 0)
        rstream = np.random.RandomState((seed[0], seed[1], 0))
        segm_len = (rstream.randint(*self.desired_segm_len)
                    if isinstance(self.desired_segm_len, tuple)
                    else self.desired_segm_len)
        lengths = np.array([utt_length])
        steps, overlap, uncovered = self.interval_cover(lengths, segm_len)
        force = rstream.uniform(0.0, 1.0, 1) < self.pr_force_align
        delay_rel = (force * (rstream.uniform(0.0, 1.0, 1) < 0.5)
                     + (1 - force) * rstream.uniform(0.0, 1.0, 1))
        delay = np.floor(uncovered * delay_rel).astype(int)
        t0s = [int(delay[0] + k * (segm_len - overlap[0]))
               for k in range(int(steps[0]))]
        for t0 in t0s:
            assert t0 + segm_len <= utt_length
        return t0s, segm_len


class SimulatedDataset:
    """Map-style dataset over tar / flat partitions with seek-based reads."""

    def __init__(self, dataset_path: str, segment_split_func: SegmentSplitter,
                 transform_fns: Sequence[Callable] = (), seed: int = 25486541,
                 sample_frac: float = 1.0, max_urls: Optional[int] = None,
                 fs: int = 16000, single_channel: bool = False,
                 max_spks: int = 3,
                 needed_columns: Optional[List[str]] = None):
        self.split_func = segment_split_func
        self.transform_fns = list(transform_fns)
        self.seed = seed
        self.epoch = 0
        # used only from __init__ (url subsampling) — single-threaded
        self.rstate = np.random.RandomState(seed)
        self.fs = fs
        self.single_channel = single_channel
        self.max_spks = max_spks
        self.total_len_sec = 0.0
        self.index = self._build_index(dataset_path, sample_frac, max_urls)
        if needed_columns is None:
            needed_columns = list(ALL_COLUMNS)
        else:
            needed_columns = list(needed_columns)
            unknown = set(needed_columns) - set(ALL_COLUMNS)
            assert not unknown, f"invalid column names: {unknown}"
        needed_columns += [f"{c}_scale" for c in needed_columns
                           if c in SCALED_COLUMNS]
        self.needed_columns = needed_columns

    # ------------------------------------------------------------------
    def _build_index(self, save_dir, sample_frac, max_urls) -> List[Dict]:
        tar_files = glob.glob(f"{save_dir}/*.tar")
        map_files = glob.glob(f"{save_dir}/*.map")
        assert (bool(tar_files) + bool(map_files)) == 1, \
            "expecting either tar files or individual utterances"
        files = tar_files or map_files
        files.sort()
        urls = [Path(f).absolute().as_posix() for f in files]
        urls = self.rstate.choice(urls, math.ceil(len(urls) * sample_frac),
                                  replace=False)
        if max_urls is not None:
            urls = urls[:min(max_urls, len(urls))]
        index = []
        for url in urls:
            if url.endswith(".tar"):
                with tarfile.open(url, "r") as tf:
                    utt_map = json.loads(
                        tf.extractfile("utterances.map").read())
            else:
                with open(url, "rb") as f:
                    utt_map = json.loads(f.read())
            for uid, length in utt_map.items():
                self.total_len_sec += length / self.fs
                segments, _ = self.split_func(length)
                for k in range(len(segments)):
                    index.append(dict(id=uid, index=k, url=url, size=length))
        return index

    def get_length_seconds(self) -> float:
        return self.total_len_sec

    def set_epoch(self, epoch: int):
        """Re-jitter the per-epoch segment covers (DataLoader forwards this)."""
        self.epoch = epoch

    def __len__(self):
        return len(self.index)

    # ------------------------------------------------------------------
    def _read_segment(self, uid: str, source, offset: int, seg_len: int
                      ) -> Dict:
        def seek_read(filename, offset=None, row_size=None, seg_len=None):
            if isinstance(source, tarfile.TarFile):
                f = source.extractfile(filename)
                if offset is None:
                    return f.read()
                f.seek(offset * row_size)
                return f.read() if seg_len is None else f.read(seg_len * row_size)
            path = source / filename
            with open(path, "rb") as f:
                if offset is None:
                    return f.read()
                f.seek(offset * row_size)
                return f.read() if seg_len is None else f.read(seg_len * row_size)

        meta = json.loads(seek_read(f"{uid}.json"))
        columns = meta["columns"]
        assert meta["index_value"] == uid
        d = {"utterance_id": uid, "t0": offset, "seg_len": seg_len}
        lib = None if isinstance(source, tarfile.TarFile) else _load_segread()
        for column in self.needed_columns:
            spec = columns[column]
            if "values" in spec:
                d[column] = float(spec["values"])
                continue
            shape = list(spec["shape"])
            if seg_len is not None:
                shape[0] = seg_len
            scale_key = f"{column}_scale"
            if (lib is not None and spec["dtype"] == "int16"
                    and scale_key in columns):
                # native path: one GIL-free open/seek/read/descale call
                import ctypes
                out = np.empty(shape, np.float32)
                rc = lib.read_scaled_segment_i16(
                    str(source / f"{uid}.{column}").encode(),
                    int(offset or 0), int(shape[0]),
                    int(spec["element_in_row"]),
                    float(columns[scale_key]["values"]),
                    out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
                if rc == 0:
                    d[column] = out  # pre-scaled float32
                    continue
            raw = seek_read(f"{uid}.{column}", offset=offset,
                            row_size=spec["row_size"], seg_len=seg_len)
            arr = np.frombuffer(raw, dtype=spec["dtype"]).copy()
            d[column] = arr.reshape(shape)
        return d

    def __getitem__(self, idx: int) -> Dict:
        utt = self.index[idx]
        # per-item RNG derived from (seed, epoch, idx): deterministic and
        # safe under the DataLoader's thread pool (a shared RandomState is
        # not thread-safe and would make segment jitter order-dependent)
        item_rng = np.random.RandomState((self.seed, self.epoch, idx))
        rand_seed = item_rng.randint(int(1e9))
        segments, seg_len = self.split_func(utt["size"], seed=(rand_seed, 0))
        url = utt["url"]
        if url.endswith(".tar"):
            with tarfile.open(url, "r") as tf:
                seg = self._read_segment(utt["id"], tf,
                                         segments[utt["index"]], seg_len)
        else:
            seg = self._read_segment(utt["id"], Path(url).parent,
                                     segments[utt["index"]], seg_len)

        # int16 -> float32 via the per-column scale factors (columns already
        # descaled by the native reader arrive as float32 and are skipped)
        scale_cols = [c for c in seg if c.endswith("_scale")]
        for sc in scale_cols:
            col = sc[:-len("_scale")]
            if seg[col].dtype == np.int16:
                seg[col] = seg[col].astype(np.float32) / seg[sc]
            else:
                assert seg[col].dtype == np.float32
        for sc in scale_cols:
            del seg[sc]

        if self.single_channel:
            for k in SCALED_COLUMNS:
                if k in seg:
                    seg[k] = seg[k][:, 0:1]

        for fn in self.transform_fns:
            seg = fn(seg, (item_rng.randint(int(1e9)), 0))

        self._pad_to_max_spks(seg)
        return seg

    def _pad_to_max_spks(self, seg: Dict):
        for k in ["gt_spk_activity_scores", "gt_spk_direct_early_echoes",
                  "gt_spk_reverb"]:
            if k not in seg:
                continue
            cur = seg[k].shape[-1]
            assert cur <= self.max_spks
            if cur == self.max_spks:
                continue
            pad_value = -1 if k == "gt_spk_activity_scores" else 0.0
            pads = [(0, 0)] * (seg[k].ndim - 1) + [(0, self.max_spks - cur)]
            seg[k] = np.pad(seg[k], pads, constant_values=pad_value)
        assert "gt_spk_activity_scores" not in seg or \
            seg["gt_spk_activity_scores"].dtype == np.int8


class DataLoader:
    """Minimal shuffling batch loader with threaded prefetch.

    Replaces the torch DataLoader/DistributedSampler pair: shuffling is
    seeded per epoch (set_epoch), batches are stacked numpy dicts, and an
    optional thread pool overlaps the byte-seek reads with device compute.
    For multi-process training each process constructs the loader with its
    (shard_index, num_shards) to read a disjoint strided subset — the same
    strategy as DistributedSampler.
    """

    def __init__(self, dataset, batch_size: int, shuffle: bool = True,
                 seed: int = 0, drop_last: bool = True, num_threads: int = 8,
                 shard_index: int = 0, num_shards: int = 1):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.drop_last = drop_last
        self.epoch = 0
        self.num_threads = num_threads
        self.shard_index = shard_index
        self.num_shards = num_shards

    def set_epoch(self, epoch: int):
        self.epoch = epoch
        if hasattr(self.dataset, "set_epoch"):
            self.dataset.set_epoch(epoch)

    def _shard_size(self) -> int:
        # shards are padded (by wrap-around repetition, the DistributedSampler
        # strategy) to a common size so every process sees the same number of
        # batches and the same ragged tail — required for SPMD lockstep
        return -(-len(self.dataset) // self.num_shards)

    def __len__(self):
        n = self._shard_size()
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def __iter__(self):
        order = np.arange(len(self.dataset))
        if self.shuffle:
            np.random.RandomState((self.seed, self.epoch)).shuffle(order)
        if self.num_shards > 1:
            pad = self._shard_size() * self.num_shards - len(order)
            order = np.concatenate([order, order[:pad]])
        order = order[self.shard_index::self.num_shards]
        usable = len(order) - (len(order) % self.batch_size
                               if self.drop_last else 0)
        pool = ThreadPoolExecutor(self.num_threads) if self.num_threads else None
        try:
            for i in range(0, usable, self.batch_size):
                idxs = order[i:i + self.batch_size]
                if len(idxs) == 0:
                    break
                if pool is not None:
                    items = list(pool.map(self.dataset.__getitem__, idxs))
                else:
                    items = [self.dataset[j] for j in idxs]
                yield _collate(items)
        finally:
            if pool is not None:
                pool.shutdown(wait=False)


def _collate(items: List[Dict]) -> Dict:
    out = {}
    for k in items[0]:
        v0 = items[0][k]
        if isinstance(v0, np.ndarray):
            out[k] = np.stack([it[k] for it in items])
        else:
            out[k] = [it[k] for it in items]
    return out


class DummySimulatedDataset:
    """All-zeros dataset for throughput tests (simulated_dataset.py:418-435)."""

    def __init__(self, num_samples: int = 100000,
                 desired_segm_len: int = 48000, max_spks: int = 3,
                 num_mics: int = 7):
        self.num_samples = num_samples
        self.desired_segm_len = desired_segm_len
        self.max_spks = max_spks
        self.num_mics = num_mics

    def __len__(self):
        return self.num_samples

    def get_length_seconds(self):
        return self.num_samples * self.desired_segm_len / 16000

    def __getitem__(self, idx):
        T, M, S = self.desired_segm_len, self.num_mics, self.max_spks
        return {
            "mixture": np.zeros((T, M), np.float32),
            "gt_spk_direct_early_echoes": np.zeros((T, M, S), np.float32),
            "gt_noise": np.zeros((T, M), np.float32),
        }
