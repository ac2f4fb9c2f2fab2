"""ctypes bindings for the native data-path library (native/misonet_native.cpp;
a copy of misonet_tpu/data/native.py binding the same library, which
belongs to neither package).

Provides fast wav decode and batched decode+chunk shard packing; every entry
point falls back to the pure-Python implementation when the shared library is
absent, so the framework works unbuilt (build with ``make -C native``)."""

from __future__ import annotations

import ctypes
import os
from pathlib import Path

import numpy as np

_LIB_PATH = Path(__file__).resolve().parents[2] / "native" / "libmisonet_native.so"
_lib = None


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not _LIB_PATH.exists():
        return None
    lib = ctypes.CDLL(str(_LIB_PATH))
    lib.wav_info.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_long),
        ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.wav_info.restype = ctypes.c_int
    lib.wav_read.argtypes = [
        ctypes.c_char_p,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_long,
    ]
    lib.wav_read.restype = ctypes.c_long
    lib.chunk_count.argtypes = [ctypes.c_long] * 3
    lib.chunk_count.restype = ctypes.c_long
    lib.pack_shards.argtypes = [
        ctypes.POINTER(ctypes.c_char_p),
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_long),
        ctypes.c_long,
        ctypes.c_long,
        ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.c_int,
    ]
    lib.pack_shards.restype = ctypes.c_int
    _lib = lib
    return lib


def available() -> bool:
    return _load() is not None


def wav_info(path: str | Path) -> tuple[int, int, int]:
    """(frames, channels, sample_rate) without decoding."""
    lib = _load()
    if lib is None:
        from misonet_tpu_torch.data.wavio import read_wav

        data, sr = read_wav(path)
        ch = 1 if data.ndim == 1 else data.shape[1]
        return data.shape[0], ch, sr
    frames = ctypes.c_long()
    ch = ctypes.c_int()
    rate = ctypes.c_int()
    rc = lib.wav_info(str(path).encode(), ctypes.byref(frames),
                      ctypes.byref(ch), ctypes.byref(rate))
    if rc != 0:
        raise OSError(f"wav_info failed ({rc}) for {path}")
    return frames.value, ch.value, rate.value


def read_wav_native(path: str | Path) -> tuple[np.ndarray, int]:
    """Native wav decode -> (float32 [S] or [S, C], rate); python fallback."""
    lib = _load()
    if lib is None:
        from misonet_tpu_torch.data.wavio import read_wav

        return read_wav(path)
    frames, ch, rate = wav_info(path)
    out = np.empty((frames, ch), np.float32)
    got = lib.wav_read(
        str(path).encode(),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        frames,
    )
    if got < 0:
        raise OSError(f"wav_read failed ({got}) for {path}")
    out = out[:got]
    return (out[:, 0] if ch == 1 else out), rate


def chunk_count(frames: int, chunk: int, least: int) -> int:
    """Train-chunk count for a ``frames``-sample signal — delegates to the
    native chunk_count when built (single source of the window geometry
    alongside ops.chunk.train_chunks, which it is parity-tested against)."""
    lib = _load()
    if lib is not None:
        return int(lib.chunk_count(frames, chunk, least))
    c, start = 0, 0
    while frames - start >= least:
        c += 1
        start += least
    return c


def pack_shards(
    paths: list[str | Path],
    chunk: int,
    least: int,
    channels: int,
    num_threads: int = 0,
) -> np.ndarray:
    """Decode + chunk many wav files into one [total_chunks, chunk, C]
    batch buffer using the threaded native packer; python fallback uses
    ops.chunk.train_chunks."""
    lib = _load()
    if lib is None:
        from misonet_tpu_torch.data.wavio import read_wav
        from misonet_tpu_torch.ops.chunk import train_chunks

        chunks = []
        for p in paths:
            data, _ = read_wav(p)
            if data.ndim == 1:
                data = data[:, None]
            chunks.extend(train_chunks(data, chunk, least))
        return (
            np.stack(chunks)
            if chunks
            else np.zeros((0, chunk, channels), np.float32)
        )

    offsets = []
    total = 0
    for p in paths:
        frames, ch, _ = wav_info(p)
        if ch != channels:
            raise ValueError(f"{p}: {ch} channels, expected {channels}")
        offsets.append(total)
        total += lib.chunk_count(frames, chunk, least)
    out = np.zeros((total, chunk, channels), np.float32)
    c_paths = (ctypes.c_char_p * len(paths))(
        *[str(p).encode() for p in paths]
    )
    c_offsets = (ctypes.c_long * len(paths))(*offsets)
    nt = num_threads or min(8, os.cpu_count() or 1)
    rc = lib.pack_shards(
        c_paths,
        len(paths),
        c_offsets,
        chunk,
        least,
        channels,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        nt,
    )
    if rc != 0:
        raise OSError(f"pack_shards failed on file #{rc - 1}: {paths[rc - 1]}")
    return out
