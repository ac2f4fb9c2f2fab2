"""Online training data pipeline: shard files -> device-ready batches (a
copy of misonet_tpu/data/dataset.py: numpy on the host, no JAX).

Replaces the reference's torch DataLoader + in-worker scipy STFT
(dataloader/data.py:17-101, 70 worker processes, NN_BSS.yml:96): the host
only reads shards and collates time-domain batches; the STFT runs inside the
train step on the device (misonet_tpu_torch/train/steps.py), which removes the
reference's CPU-side STFT bottleneck entirely (SURVEY.md §3.2 hot loop).

Also supports the reference's legacy per-chunk pickle shards
({mix, ref1, ref2} dicts, SMS_WSJ.py:147-226) alongside our .npz format.

Multi-host: each process constructs the dataset with its (host_index,
host_count) and sees an interleaved slice of the shard list — per-host input
sharding feeding the data-parallel mesh (SURVEY.md §2.10 item 5).
"""

from __future__ import annotations

import pickle
import queue
import threading
from pathlib import Path

import numpy as np


class ShardDataset:
    """Indexable dataset over extracted chunk shards.

    Each item: dict {"mix": [S, C] float32, "ref": [num_spks, S] float32}."""

    def __init__(
        self,
        shard_dir: str | Path,
        num_spks: int = 2,
        host_index: int = 0,
        host_count: int = 1,
        with_features: bool = False,
        num_ch_utilize: int = 0,
        extra_keys: tuple[str, ...] = (),
    ):
        root = Path(shard_dir)
        files = sorted(
            [p for p in root.rglob("*.npz") if not p.name.endswith(".feat.npz")]
            + list(root.rglob("*.pickle"))
        )
        if not files:
            raise FileNotFoundError(f"no shards under {root}")
        self.files = files[host_index::host_count]
        self.num_spks = num_spks
        # Load precomputed MISO1/BF companions (the reference's
        # load_MISO1_Output / load_MVDR_Output modes, data.py:133-145).
        self.with_features = with_features
        # Mic subsampling [0:M:M//num_ch_utilize] (reference data.py:81,:92);
        # 0 keeps all channels.
        self.num_ch_utilize = num_ch_utilize
        # Companion signals stored by the extractor (early/tail/noise keys,
        # reference SMS_WSJ.py:102-127) passed through when present.
        self.extra_keys = tuple(extra_keys)

    def __len__(self) -> int:
        return len(self.files)

    def __getitem__(self, idx: int) -> dict[str, np.ndarray]:
        path = self.files[idx]
        extras = {}
        if path.suffix == ".npz":
            with np.load(path) as z:
                mix = z["mix"]
                refs = [z[f"ref{s + 1}"] for s in range(self.num_spks)]
                extras = {k: z[k] for k in self.extra_keys if k in z.files}
        else:  # reference-format pickle (data.py:72-77)
            with open(path, "rb") as f:
                d = pickle.load(f)
            mix = np.asarray(d["mix"], np.float32)
            refs = [
                np.asarray(d[f"ref{s + 1}"], np.float32)
                for s in range(self.num_spks)
            ]
        if mix.ndim == 1:
            mix = mix[:, None]
        if self.num_ch_utilize and mix.shape[1] > self.num_ch_utilize:
            m = mix.shape[1]
            mix = mix[:, 0 : m : m // self.num_ch_utilize]
        refs = [r[:, 0] if r.ndim > 1 else r for r in refs]
        item = {"mix": mix, "ref": np.stack(refs, axis=0), **extras}
        if self.with_features:
            feat_path = path.with_suffix(".feat.npz")
            with np.load(feat_path) as z:
                item["miso1"] = z["miso1"]
                item["bf"] = z["bf"]
        return item


class Batcher:
    """Shuffling, batching, prefetching iterator.

    Yields {"mix": [B, S, C], "ref": [B, num_spks, S]} float32 numpy arrays
    (time-domain; STFT happens on device).  Drops the last partial batch so
    every step sees one shape.  A background thread keeps ``prefetch`` batches
    ready — the single-worker analogue of the reference's 70-process
    DataLoader, sufficient because the heavy DSP moved to the device."""

    def __init__(
        self,
        dataset: ShardDataset,
        batch_size: int,
        shuffle: bool = True,
        seed: int = 0,
        prefetch: int = 2,
    ):
        self.dataset = dataset
        self.batch_size = batch_size
        self.shuffle = shuffle
        self.rng = np.random.default_rng(seed)
        self.prefetch = prefetch

    def __len__(self) -> int:
        return len(self.dataset) // self.batch_size

    def _epoch_order(self) -> np.ndarray:
        order = np.arange(len(self.dataset))
        if self.shuffle:
            self.rng.shuffle(order)
        return order

    def _collate(self, idxs) -> dict[str, np.ndarray]:
        items = [self.dataset[int(i)] for i in idxs]
        return {k: np.stack([it[k] for it in items]) for k in items[0]}

    def __iter__(self):
        order = self._epoch_order()
        batches = [
            order[i : i + self.batch_size]
            for i in range(0, len(order) - self.batch_size + 1, self.batch_size)
        ]
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        stop = object()
        abandoned = threading.Event()

        def put(item) -> bool:
            # bounded put loop so an abandoned iterator (consumer broke
            # out mid-epoch) releases the thread instead of leaving it
            # blocked forever on a full queue of multi-MB batches
            while not abandoned.is_set():
                try:
                    q.put(item, timeout=0.2)
                    return True
                except queue.Full:
                    continue
            return False

        def producer():
            try:
                for idxs in batches:
                    if not put(self._collate(idxs)):
                        return
                put(stop)
            except Exception as e:  # raised in the consumer: no silent hang
                put(_ProducerError(e))

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is stop:
                    break
                if isinstance(item, _ProducerError):
                    raise item.error
                yield item
        finally:
            abandoned.set()


class _ProducerError:
    """An exception of the Batcher's producer thread, on its way to the
    consumer (the JAX package's Batcher loses it and its consumer waits
    forever)."""

    def __init__(self, error: Exception):
        self.error = error
