"""Inference chunking: non-overlapping splits with tail zero-pad ``gap``
bookkeeping (reference dataloader/data.py:524-597, tester.py:170-179).

Numpy only, like misonet_tpu/ops/chunk.py; copied rather than imported
because importing that module pulls in JAX through its package."""

from __future__ import annotations

import numpy as np


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
