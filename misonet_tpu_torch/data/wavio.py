"""WAV I/O on the host (a copy of misonet_tpu/data/wavio.py, kept apart so
that the port imports nothing of the JAX package).

The reference reads with librosa and writes with soundfile
(dataloader/data.py:613, tester.py:181); this goes through
scipy.io.wavfile with the same numeric conventions: float arrays in
[-1, 1], int16 quantization via MaxINT16 scaling on write
(tester.py:156-157), PCM_16 or PCM_24 on disk."""

from __future__ import annotations

from pathlib import Path

import numpy as np
import scipy.io.wavfile as wf

MAX_INT16 = np.iinfo(np.int16).max


def read_wav(path: str | Path) -> tuple[np.ndarray, int]:
    """Read a wav file -> (float32 [S] or [S, C] in [-1, 1], sample rate)."""
    sr, data = wf.read(str(path))
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    return data, sr


def write_wav(
    path: str | Path,
    data: np.ndarray,
    sample_rate: int,
    subtype: str = "PCM_16",
) -> None:
    """Write float [-1,1] (or already-int16) audio, matching the
    reference's MaxINT16 quantization (tester.py:156-157).

    ``subtype="PCM_24"`` reproduces the reference's on-disk sample format
    (soundfile 'PCM_24', tester.py:157,181): the int16-quantized samples
    are shifted into the top bytes of 24-bit frames — numerically
    identical to soundfile's int16 -> 24-bit promotion (headers may
    differ: soundfile emits extra metadata chunks)."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    if data.dtype != np.int16:
        data = np.clip(data, -1.0, 1.0)
        data = (data * MAX_INT16).astype(np.int16)
    if subtype == "PCM_16":
        wf.write(str(path), sample_rate, data)
    elif subtype == "PCM_24":
        _write_pcm24(Path(path), data, sample_rate)
    else:
        raise ValueError(f"unsupported subtype {subtype!r}")


def _write_pcm24(path: Path, data: np.ndarray, sample_rate: int) -> None:
    """Minimal RIFF writer for 24-bit PCM (scipy.io.wavfile cannot emit
    it): int16 samples promoted by an 8-bit left shift, frames packed as
    3 little-endian bytes."""
    import struct

    if data.ndim == 1:
        data = data[:, None]
    frames, ch = data.shape
    # int16 -> int32 << 8, then take the low 3 bytes of each sample
    s32 = (data.astype(np.int32) << 8).astype("<i4")
    raw = s32.view(np.uint8).reshape(frames, ch, 4)[:, :, :3].tobytes()
    byte_rate = sample_rate * ch * 3
    block_align = ch * 3
    # RIFF requires word-aligned chunks: odd-sized data gets a zero pad
    # byte (counted in the RIFF size, NOT in the data chunk size field)
    pad = b"\x00" if len(raw) % 2 else b""
    hdr = b"RIFF" + struct.pack("<I", 36 + len(raw) + len(pad)) + b"WAVE"
    hdr += b"fmt " + struct.pack(
        "<IHHIIHH", 16, 1, ch, sample_rate, byte_rate, block_align, 24
    )
    hdr += b"data" + struct.pack("<I", len(raw))
    path.write_bytes(hdr + raw + pad)
