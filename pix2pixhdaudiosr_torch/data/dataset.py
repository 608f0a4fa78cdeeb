"""Datasets and the host input pipeline.

Port of pix2pixhdaudiosr_tpu/data/dataset.py:37-239 (that package's `data`
imports jax):
  * AudioDataset: training (hr, lr) segment pairs: a random segment offset
    read at the file's own rate, retry-next-file on a decode error,
    hr = resample(orig -> hr_rate), lr = resample(resample(orig -> lr_rate)
    -> hr_rate), cropped or zero-padded to segment_length; optionally the
    resampled pair of each whole file cached on disk (`cache_dir`).
  * AudioTestDataset: one file, resampled down to the low rate and back up
    (or only up, with is_lr_input), chopped into consecutive
    segment_length windows (the generate CLI's input).
  * Loader: batches of dataset indices, decoded by a few threads, prefetched
    and delivered in order.
Resampling runs in the port's native C++ library (runtime/native_audio.py,
a copy of the JAX package's, built with g++ at first use), as the JAX
dataset's `_resample` does (:37-39); the numpy polyphase
`resample_np` is its oracle. A library that does not build stops the
run: nothing falls back. PERF.md §3 has the input pipeline's host times.
"""

from __future__ import annotations

import hashlib
import os
import queue
import struct
import threading
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from ..runtime import native_audio
from .filelist import discover_files
from .wavio import read_wav, wav_info


class AudioDataset:
    """Training dataset of (hr, lr) waveform segment pairs.

    With `cache_dir`, each file's full-length (hr, lr) pair is resampled
    once and memory-mapped thereafter; segment offsets stay random."""

    def __init__(self, dataroot: str, lr_sampling_rate: int,
                 hr_sampling_rate: int, segment_length: int, seed: int = 1234,
                 max_dataset_size: Optional[int] = None,
                 files: Optional[List[str]] = None,
                 cache_dir: Optional[str] = None):
        self.files = files if files is not None else \
            discover_files(dataroot, max_dataset_size)
        self.lr_rate = lr_sampling_rate
        self.hr_rate = hr_sampling_rate
        self.segment_length = segment_length
        self.rng = np.random.default_rng(seed)
        self.cache_dir = cache_dir
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)

    def __len__(self) -> int:
        return len(self.files)

    def _read_segment(self, path: str) -> tuple:
        info = wav_info(path)
        max_start = info.num_frames - self.segment_length
        offset = int(self.rng.integers(0, max_start)) if max_start > 0 else 0
        n = self.segment_length if max_start > 0 else None
        wav, rate = read_wav(path, frame_offset=offset, num_frames=n)
        return wav[0], rate  # the first channel

    def _seg_pad(self, x: np.ndarray) -> np.ndarray:
        if len(x) >= self.segment_length:
            return x[: self.segment_length]
        return np.pad(x, (0, self.segment_length - len(x)))

    def _cache_path(self, path: str) -> str:
        h = hashlib.sha1(os.path.abspath(path).encode()).hexdigest()[:16]
        return os.path.join(self.cache_dir,
                            f"{h}_{self.lr_rate}_{self.hr_rate}.npz")

    def _cached_pair(self, path: str):
        """Full-file (hr, lr) pair via the on-disk cache; random segment cut."""
        cpath = self._cache_path(path)
        if not os.path.exists(cpath):
            wav, rate = read_wav(path)
            wav = wav[0]
            resample = native_audio.resample
            hr = resample(wav, rate, self.hr_rate).astype(np.float32)
            lr = resample(resample(wav, rate, self.lr_rate),
                          self.lr_rate, self.hr_rate).astype(np.float32)
            np.savez(cpath, hr=hr, lr=lr[: len(hr)])
        z = np.load(cpath, mmap_mode="r")
        hr, lr = z["hr"], z["lr"]
        max_start = len(hr) - self.segment_length
        off = int(self.rng.integers(0, max_start)) if max_start > 0 else 0
        return (np.asarray(hr[off: off + self.segment_length]),
                np.asarray(lr[off: off + self.segment_length]))

    def __getitem__(self, idx: int) -> Dict[str, np.ndarray]:
        # on a decode failure, try the next file, round the whole list
        path = self.files[idx]
        for i in range(len(self.files)):
            try:
                if self.cache_dir:
                    hr, lr = self._cached_pair(path)
                else:
                    wav, rate = self._read_segment(path)
                    resample = native_audio.resample
                    hr = resample(wav, rate, self.hr_rate)
                    lr = resample(resample(wav, rate, self.lr_rate),
                                  self.lr_rate, self.hr_rate)
                break
            except (OSError, ValueError, EOFError, struct.error):
                path = self.files[(idx + i + 1) % len(self.files)]
        else:
            raise RuntimeError("no decodable audio file found")
        return {"image": self._seg_pad(hr).astype(np.float32),
                "label": self._seg_pad(lr).astype(np.float32),
                "inst": np.int32(0), "feat": np.float32(0), "path": path}


class AudioTestDataset:
    def __init__(self, dataroot: str, lr_sampling_rate: int,
                 hr_sampling_rate: int, segment_length: int,
                 is_lr_input: bool = False):
        self.segment_length = segment_length
        wav, rate = read_wav(dataroot)
        self.raw_audio = wav[0]
        self.in_sampling_rate = rate
        self.audio_len = len(self.raw_audio)
        self.dataroot = dataroot
        if is_lr_input:
            self.lr_audio = native_audio.resample(self.raw_audio, rate,
                                                  hr_sampling_rate)
        else:
            lo = native_audio.resample(self.raw_audio, rate, lr_sampling_rate)
            self.lr_audio = native_audio.resample(lo, lr_sampling_rate,
                                                  hr_sampling_rate)
        n = len(self.lr_audio)
        num_seg = max(1, int(np.ceil(n / segment_length)))
        padded = np.pad(self.lr_audio, (0, num_seg * segment_length - n))
        self.segments = padded.reshape(num_seg, segment_length).astype(np.float32)

    def __len__(self) -> int:
        return self.segments.shape[0]


class Loader:
    """Threaded, prefetching batch loader over dataset indices: batches of
    `batch_size` (the last partial one dropped when drop_last), shuffled
    anew each epoch from seed + epoch, decoded by `n_threads` threads and
    delivered in order. With `shard=(rank, n)` (data parallelism) the
    batches are the same global ones and this loader decodes and delivers
    only rank `rank`'s equal share of each batch's rows."""

    def __init__(self, dataset, indices: Sequence[int], batch_size: int,
                 shuffle: bool = True, seed: int = 1234, n_threads: int = 2,
                 drop_last: bool = True, prefetch: int = 4,
                 shard: Tuple[int, int] = (0, 1)):
        self.dataset = dataset
        self.indices = list(indices)
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.seed = seed
        self.n_threads = max(1, n_threads)
        self.drop_last = drop_last
        self.prefetch = prefetch
        self.epoch = 0
        rank, n = shard
        if batch_size % n:
            raise ValueError(f"a batch of {batch_size} does not split over "
                             f"{n} ranks")
        self.rows = slice(rank * (batch_size // n),
                          (rank + 1) * (batch_size // n)) if n > 1 else slice(None)

    def __len__(self) -> int:
        n = len(self.indices)
        return n // self.batch_size if self.drop_last else -(-n // self.batch_size)

    def _batches(self) -> List[List[int]]:
        idx = list(self.indices)
        if self.shuffle:
            np.random.default_rng(self.seed + self.epoch).shuffle(idx)
        out = [idx[i: i + self.batch_size]
               for i in range(0, len(idx), self.batch_size)]
        if self.drop_last:
            out = [b for b in out if len(b) == self.batch_size]
        return out

    def __iter__(self) -> Iterator[Dict[str, np.ndarray]]:
        batches = self._batches()
        self.epoch += 1
        if not batches:
            return
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()

        def collate(batch_idx):
            items = [self.dataset[i] for i in batch_idx[self.rows]]
            return {"image": np.stack([it["image"] for it in items]),
                    "label": np.stack([it["label"] for it in items]),
                    "path": [it["path"] for it in items]}

        def put(item) -> bool:
            """Queue item unless the consumer has stopped; False if so."""
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def worker(shard):
            try:
                for bi, b in shard:
                    if not put((bi, collate(b))):
                        return
            except Exception as e:  # handed to the consumer, which raises it
                put((-1, e))

        jobs = list(enumerate(batches))
        shards = [jobs[t:: self.n_threads] for t in range(self.n_threads)]
        threads = [threading.Thread(target=worker, args=(s,), daemon=True)
                   for s in shards if s]
        for t in threads:
            t.start()
        try:
            pending, next_i, received = {}, 0, 0
            while received < len(jobs):
                bi, payload = q.get()
                if bi == -1:
                    raise payload
                received += 1
                pending[bi] = payload
                while next_i in pending:  # deliver in order
                    yield pending.pop(next_i)
                    next_i += 1
        finally:
            stop.set()
            for t in threads:
                t.join(timeout=10)
