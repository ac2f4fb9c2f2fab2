"""Utterance-level MISO1 separation serving (misonet_tpu/inference/evaluate.py,
the reference's Tester_Separate, tester.py:16-255).

Per utterance: 4 s splits with ``gap`` bookkeeping, padded to a power-of-two
bucket -> STFT -> batched circular-shift MISO1 decode -> per-chunk alignment
to the clean references (tester.py:125-147), or chained to the previous
chunk without references -> iSTFT per speaker and stitch -> PIT SI-SDR.

This port covers the MISO1-only mode (``beamform_utterance=False`` and no
enhance model).  The MVDR and MISO2/3 tails raise ``NotImplementedError``.
"""

from __future__ import annotations

import dataclasses
import itertools

import numpy as np
import torch

from misonet_tpu_torch.config import DatasetConfig, StftConfig
from misonet_tpu_torch.inference.separate import align_slots, make_full_array_decode
from misonet_tpu_torch.losses import magnitude_distance
from misonet_tpu_torch.metrics import numpy_si_sdr
from misonet_tpu_torch.ops.chunk import merge_chunks, split_chunks
from misonet_tpu_torch.ops.stft import istft_scaled, stft_scaled


def _next_bucket(n: int) -> int:
    """Smallest power of two >= n."""
    b = 1
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class UtteranceResult:
    separated: np.ndarray          # [S, samples] time-domain per speaker
    beamformed: np.ndarray | None  # always None in the MISO1-only port
    enhanced: np.ndarray | None    # always None in the MISO1-only port
    si_sdr: dict[str, float]       # per-stage PIT SI-SDR when refs given


class CascadeEvaluator:
    """MISO1 separation of whole utterances on the model's device.

    ``miso1_model`` is a port ``MISONet`` holding its parameters.  Only
    ``beamform_utterance=False`` without an enhance model is ported."""

    def __init__(
        self,
        miso1_model,
        stft_cfg: StftConfig,
        ds_cfg: DatasetConfig,
        enhance_model=None,
        beamform_utterance: bool = True,
    ):
        if beamform_utterance or enhance_model is not None:
            raise NotImplementedError(
                "the PyTorch port's CascadeEvaluator runs MISO1 separation "
                "only (beamform_utterance=False, no enhance model); the MVDR "
                "and MISO2/3 cascade modes are ROADMAP items"
            )
        self.model = miso1_model
        self.stft_cfg = stft_cfg
        self.ds = ds_cfg
        self.device = next(miso1_model.parameters()).device
        self.decode = make_full_array_decode(
            miso1_model, ds_cfg.num_ch_utilize, ds_cfg.ref_ch
        )

    @torch.inference_mode()
    def _decode_align(self, mix, ref_stft):
        """Decode + per-chunk alignment to the references (or chained to
        the previous chunk when ``ref_stft`` is None) + gather.
        Returns (full [N, S, C, T, F], at the reference mic [N, S, T, F])."""
        ref_ch = self.ds.ref_ch
        full = self.decode(mix)                          # [N, S, C, T, F]
        m_ref = full[:, :, ref_ch]
        if ref_stft is not None:
            idx = align_slots(magnitude_distance(m_ref, ref_stft))
        else:
            idx = _chain_alignment_scan(m_ref)
        full = torch.take_along_dim(full, idx[:, :, None, None, None], dim=1)
        return full, full[:, :, ref_ch]

    def _stft(self, pieces: np.ndarray) -> torch.Tensor:
        """[Nb, chunk, C] host chunks -> [Nb, C, T, F] on the device."""
        x = torch.from_numpy(np.ascontiguousarray(pieces.transpose(0, 2, 1)))
        return stft_scaled(x.to(self.device, torch.float32), self.stft_cfg)

    def process(self, mix_wave: np.ndarray,
                refs: np.ndarray | None = None) -> UtteranceResult:
        """mix_wave: [samples, C] float32; refs: [S, samples] or None."""
        chunk = self.ds.chunk_samples
        pieces, gap = split_chunks(mix_wave, chunk)       # [N, chunk, C]
        n = pieces.shape[0]
        nb = _next_bucket(n)
        mix = self._stft(_pad_bucket(pieces, nb))           # [Nb, C, T, F]
        ref_stft = None
        if refs is not None:
            ref_pieces, _ = split_chunks(np.ascontiguousarray(refs.T), chunk)
            ref_stft = self._stft(_pad_bucket(ref_pieces, nb))
        _, miso1_ref = self._decode_align(mix, ref_stft)

        out_len = mix_wave.shape[0]
        separated = self._stitch(miso1_ref, n, gap, out_len)  # [S, samples]
        scores: dict[str, float] = {}
        if refs is not None:
            scores["miso1"] = _pit_si_sdr(separated, refs)
        return UtteranceResult(separated, None, None, scores)

    def _stitch(self, spec: torch.Tensor, n: int, gap: int,
                out_len: int) -> np.ndarray:
        """[N(,bucketed), S, T, F] chunk spectrograms -> [S, out_len] wave."""
        chunk = self.ds.chunk_samples
        wav = istft_scaled(spec[:n], self.stft_cfg, chunk)  # [N, S, chunk]
        wav = wav.cpu().numpy().transpose(1, 0, 2)          # [S, N, chunk]
        return np.stack(
            [merge_chunks(w[:, :, None], gap)[:, 0] for w in wav]
        )[:, :out_len]


def _pad_bucket(pieces: np.ndarray, nb: int) -> np.ndarray:
    n = pieces.shape[0]
    if nb == n:
        return pieces
    pad = np.zeros((nb - n,) + pieces.shape[1:], pieces.dtype)
    return np.concatenate([pieces, pad])


def _chain_alignment_scan(miso1_ref: torch.Tensor) -> torch.Tensor:
    """[N, S, T, F] chunk estimates -> [N, S] slot indices chaining each
    chunk's speakers to the previous (aligned) chunk's magnitudes."""
    s = miso1_ref.shape[1]
    mags = miso1_ref.abs()
    prev = mags[0]
    idxs = [torch.arange(s, device=mags.device)]
    for mag_i in mags[1:]:
        d = (prev[:, None] - mag_i[None, :]).abs().sum(dim=(-2, -1))
        idx = align_slots(d[None])[0]
        prev = mag_i[idx]
        idxs.append(idx)
    return torch.stack(idxs)


def _pit_si_sdr(est: np.ndarray, refs: np.ndarray) -> float:
    """Permutation-best mean SI-SDR over speakers (host side)."""
    n = min(est.shape[-1], refs.shape[-1])
    best = -np.inf
    for perm in itertools.permutations(range(refs.shape[0])):
        val = np.mean([numpy_si_sdr(est[perm[s], :n], refs[s, :n])
                       for s in range(refs.shape[0])])
        best = max(best, val)
    return float(best)
