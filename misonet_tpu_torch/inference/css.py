"""Continuous speech separation (CSS): block-wise long-form processing with
streaming covariance updates (misonet_tpu/inference/css.py; the JAX
package's ``run.py -m Test -t CSS``).

Audio arrives in fixed 4 s blocks.  Each block runs the MISO1 decode; a
running, optionally exponentially forgetting, SCM pair per speaker feeds an
MVDR whose weights adapt as evidence accumulates (one ``mvdr_weights``
launch per block).  Block outputs are concatenated edge to edge
(``overlap=0``, the reference's chunked semantics, tester.py:949-967) or,
with ``overlap>0``, blocks advance by chunk - overlap samples and a
triangular cross-fade blends the seams.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from misonet_tpu_torch.beamforming.mvdr import (
    apply_weights,
    frame_outer_sum,
    hermitize,
    steering_weights,
)
from misonet_tpu_torch.config import DatasetConfig, StftConfig
from misonet_tpu_torch.inference.separate import align_slots, make_full_array_decode
from misonet_tpu_torch.ops.chunk import split_chunks
from misonet_tpu_torch.ops.stft import istft_scaled, stft_scaled


@dataclasses.dataclass
class CSSState:
    """Running per-speaker SCM sums and the previous block's magnitudes
    (for chaining the speaker order across blocks), on the model's device."""

    source_scm: torch.Tensor   # [S, F, C, C] complex64
    noise_scm: torch.Tensor    # [S, F, C, C] complex64
    frames: torch.Tensor       # [] float32, forgetting-weighted frame count
    prev_mag: torch.Tensor     # [S, T, F] magnitude of last block's estimates


class StreamingCSS:
    def __init__(self, miso1_model, stft_cfg: StftConfig,
                 ds_cfg: DatasetConfig, forget: float = 1.0):
        """``miso1_model`` is a port ``MISONet`` holding its parameters.
        forget=1.0 -> cumulative SCM (the reference's utterance SCM in the
        infinite-memory limit); < 1.0 -> exponential forgetting for
        non-stationary scenes."""
        self.model = miso1_model
        self.stft_cfg = stft_cfg
        self.ds = ds_cfg
        self.forget = forget
        self.device = next(miso1_model.parameters()).device
        self.decode = make_full_array_decode(
            miso1_model, ds_cfg.num_ch_utilize, ds_cfg.ref_ch
        )

    def init_state(self, num_spks: int = 2) -> CSSState:
        cfg, ds = self.stft_cfg, self.ds
        f, c = cfg.num_bins, ds.num_ch_utilize
        t = cfg.num_frames(ds.chunk_samples)
        z = torch.zeros((num_spks, f, c, c), dtype=torch.complex64,
                        device=self.device)
        return CSSState(z, z.clone(),
                        torch.zeros((), dtype=torch.float32,
                                    device=self.device),
                        torch.zeros((num_spks, t, f), device=self.device))

    @torch.inference_mode()
    def step(self, state: CSSState, block_wave: torch.Tensor):
        """block_wave [samples, C] on the device -> (new state, per-speaker
        BF spectrogram [S, T, F], MISO1 ref-mic spectrogram [S, T, F])."""
        ref_ch = self.ds.ref_ch
        mix = stft_scaled(block_wave.T, self.stft_cfg)       # [C, T, F]
        full = self.decode(mix[None])[0]                     # [S, C, T, F]
        mag = full[:, ref_ch].abs()

        # chain the speaker order to the previous block (none before the
        # first block: then the identity)
        d = (state.prev_mag[:, None] - mag[None, :]).abs().sum(dim=(-2, -1))
        idx = torch.where(state.frames > 0, align_slots(d[None])[0],
                          torch.arange(mag.shape[0], device=mag.device))
        full = full[idx]
        m_ref = full[:, ref_ch]
        mag = m_ref.abs()

        t = full.shape[-2]
        source_scm = self.forget * state.source_scm + frame_outer_sum(full)
        noise_scm = (self.forget * state.noise_scm
                     + frame_outer_sum(mix[None] - full))
        frames = self.forget * state.frames + t
        r_s = hermitize(source_scm) / frames
        r_n = hermitize(noise_scm) / frames

        bf = apply_weights(steering_weights(r_s, r_n, ref_ch), mix)  # [S,T,F]
        return CSSState(source_scm, noise_scm, frames, mag), bf, m_ref

    def process_block(self, state: CSSState, block_wave: np.ndarray):
        """One block [samples, C]: returns (state, beamformed wave
        [S, samples], MISO1 wave [S, samples])."""
        x = torch.from_numpy(np.ascontiguousarray(block_wave, np.float32))
        state, bf, m1 = self.step(state, x.to(self.device))
        n = block_wave.shape[0]
        return (
            state,
            istft_scaled(bf, self.stft_cfg, n).cpu().numpy(),
            istft_scaled(m1, self.stft_cfg, n).cpu().numpy(),
        )

    def process(self, wave: np.ndarray, overlap: int = 0):
        """A whole recording [samples, C] -> dict with the stitched
        per-speaker 'beamformed' and 'miso1' waves [S, samples].

        ``overlap`` (samples, < chunk) turns on cross-fade stitching:
        blocks advance by ``chunk - overlap`` and a triangular fade blends
        each seam; the block size stays fixed."""
        chunk = self.ds.chunk_samples
        state = self.init_state(self.ds.num_spks)
        if overlap == 0:
            pieces, gap = split_chunks(wave, chunk)
            bf_out, m1_out = [], []
            for p in pieces:
                state, bf, m1 = self.process_block(state, p)
                bf_out.append(bf)
                m1_out.append(m1)
            total = len(pieces) * chunk - gap
            return {"beamformed": np.concatenate(bf_out, axis=-1)[:, :total],
                    "miso1": np.concatenate(m1_out, axis=-1)[:, :total]}

        if not 0 < overlap < chunk:
            raise ValueError(f"overlap {overlap} must lie in (0, {chunk})")
        hop = chunk - overlap
        total = wave.shape[0]
        n_blocks = max(1, -(-max(total - overlap, 1) // hop))
        padded = np.pad(
            wave, [(0, (n_blocks - 1) * hop + chunk - total), (0, 0)]
        )
        bf_blocks, m1_blocks = [], []
        for i in range(n_blocks):
            state, bf, m1 = self.process_block(
                state, padded[i * hop : i * hop + chunk])
            bf_blocks.append(bf)
            m1_blocks.append(m1)
        return {
            "beamformed": crossfade_stitch(np.stack(bf_blocks), hop, total),
            "miso1": crossfade_stitch(np.stack(m1_blocks), hop, total),
        }


def crossfade_stitch(blocks: np.ndarray, hop: int, total: int) -> np.ndarray:
    """Overlap-add [N, S, chunk] blocks advancing by ``hop`` with a
    triangular cross-fade over the ``chunk - hop`` overlap, normalized by
    the accumulated fade weights (consistent blocks reconstruct their
    signal exactly, edges included)."""
    n, s, chunk = blocks.shape
    overlap = chunk - hop
    w = np.ones(chunk, blocks.dtype)
    if overlap > 0:
        ramp = (np.arange(1, overlap + 1) / (overlap + 1)).astype(blocks.dtype)
        w[:overlap] = ramp
        w[chunk - overlap :] = ramp[::-1]
    out = np.zeros((s, (n - 1) * hop + chunk), blocks.dtype)
    wsum = np.zeros(out.shape[-1], blocks.dtype)
    for i in range(n):
        out[:, i * hop : i * hop + chunk] += blocks[i] * w
        wsum[i * hop : i * hop + chunk] += w
    return (out / wsum[None])[:, :total]
