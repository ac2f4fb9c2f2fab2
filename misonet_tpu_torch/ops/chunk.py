"""Utterance chunking (a copy of misonet_tpu/ops/chunk.py).

* ``train_chunks``: sliding 4 s window with 2 s hop over a training
  utterance, zero-padding utterances in [least, chunk) range and dropping
  shorter ones (reference dataloader/SMS_WSJ.py:79-228).
* ``split_chunks`` / ``merge_chunks``: non-overlapping inference splits
  with tail zero-pad ``gap`` bookkeeping (reference dataloader/data.py:
  524-597, tester.py:170-179).

Numpy only, like the JAX package's; copied rather than imported because
importing that module pulls in JAX through its package."""

from __future__ import annotations

import numpy as np


def train_chunks(x: np.ndarray, chunk: int, least: int) -> list[np.ndarray]:
    """Split ``x`` ([S] or [S, C]) into 50%-overlapped training chunks.

    Windows of ``chunk`` samples advance by ``least`` samples; a tail (or a
    short utterance) of length in [least, chunk) is zero-padded to ``chunk``;
    remainders shorter than ``least`` are dropped — matching the reference
    extractor (SMS_WSJ.py:86-145, :227)."""
    n = x.shape[0]
    out: list[np.ndarray] = []
    start = 0
    while n - start >= least:
        piece = x[start : start + chunk]
        if piece.shape[0] < chunk:
            pad = [(0, chunk - piece.shape[0])] + [(0, 0)] * (x.ndim - 1)
            piece = np.pad(piece, pad)
        out.append(piece)
        start += least
    return out


def split_chunks(x: np.ndarray, chunk: int) -> tuple[np.ndarray, int]:
    """Split ``x`` ([S] or [S, C]) into non-overlapping ``chunk``-sized
    pieces, zero-padding the tail.  Returns (pieces [N, chunk, ...], gap)
    where ``gap`` is the number of padded samples in the last piece (0 when
    the length divides evenly)."""
    n = x.shape[0]
    num = max(1, -(-n // chunk))
    gap = num * chunk - n
    pad = [(0, gap)] + [(0, 0)] * (x.ndim - 1)
    xp = np.pad(x, pad)
    return xp.reshape((num, chunk) + x.shape[1:]), gap


def merge_chunks(pieces: np.ndarray, gap: int) -> np.ndarray:
    """Inverse of :func:`split_chunks`: concatenate [N, chunk, ...] pieces
    and strip the final ``gap`` padded samples."""
    flat = pieces.reshape((-1,) + pieces.shape[2:])
    return flat[: flat.shape[0] - gap] if gap else flat
