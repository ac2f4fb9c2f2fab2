"""Utterance-level evaluation: separation, MVDR beamforming and MISO2/3
enhancement (misonet_tpu/inference/evaluate.py; the reference's
Tester_Separate tester.py:16-255, Tester_Beamforming :259-794 and
Tester_Enhance :798-1258).

Per utterance: 4 s splits with ``gap`` bookkeeping, padded to a power-of-two
bucket -> STFT -> batched circular-shift MISO1 decode -> per-chunk alignment
to the clean references (tester.py:125-147), or chained to the previous
chunk without references -> a stage-dependent tail:

  separate   iSTFT per speaker, stitch (tester.py:149-183)
  beamform   utterance mode: stitch the multi-channel estimates in time,
             re-STFT the whole utterance, one SCM over its real frames,
             MVDR, iSTFT (tester.py:340-451); chunk mode: MVDR per 4 s
             split (:453-543)
  enhance    MISO2/3 per split on (mixture, MISO1, BF), iSTFT, stitch
             (:846-975)

-> per-stage PIT SI-SDR when references are given.

As in the JAX package, the enhance nets always run per chunk: with
utterance-mode beamforming the utterance-grid BF wave is cut back onto the
chunk frame grid first, since running MISO2/3 on the bucket-padded
utterance grid would push zero-pad frames into the IN/gLN statistics.
Every MVDR of a request is one ``mvdr_weights`` launch (all chunks x
speakers x bins in chunk mode, speakers x bins in utterance mode).
"""

from __future__ import annotations

import dataclasses
import itertools
from pathlib import Path

import numpy as np
import torch

from misonet_tpu_torch.beamforming.mvdr import mvdr_beamform
from misonet_tpu_torch.config import DatasetConfig, StftConfig
from misonet_tpu_torch.data.wavio import read_wav, write_wav
from misonet_tpu_torch.inference.cascade import beamform_sources, enhance
from misonet_tpu_torch.inference.separate import align_slots, make_full_array_decode
from misonet_tpu_torch.losses import magnitude_distance
from misonet_tpu_torch.metrics import numpy_si_sdr
from misonet_tpu_torch.ops.chunk import merge_chunks, split_chunks
from misonet_tpu_torch.ops.stft import (
    istft_scaled,
    istft_scaled_masked,
    mask_frames,
    stft_scaled,
)
from misonet_tpu_torch.utils import profiling


def _next_bucket(n: int) -> int:
    """Smallest power of two >= n."""
    b = 1
    while b < n:
        b *= 2
    return b


@dataclasses.dataclass
class UtteranceResult:
    separated: np.ndarray          # [S, samples] time-domain per speaker
    beamformed: np.ndarray | None  # [S, samples] or None
    enhanced: np.ndarray | None    # [S, samples] or None
    si_sdr: dict[str, float]       # per-stage PIT SI-SDR when refs given


class CascadeEvaluator:
    """The cascade over whole utterances on the models' device.

    ``miso1_model`` and ``enhance_model`` (MISO3, or MISO2 with
    ``joint=True``) are port ``MISONet``s holding their parameters.
    ``beamform_utterance`` picks utterance-mode MVDR (the default, as in
    the JAX package) or chunk mode; chunk mode without an enhance model is
    separation only."""

    def __init__(
        self,
        miso1_model,
        stft_cfg: StftConfig,
        ds_cfg: DatasetConfig,
        enhance_model=None,
        joint: bool = False,
        beamform_utterance: bool = True,
        power_iters: int = 100,
    ):
        self.model = miso1_model
        self.stft_cfg = stft_cfg
        self.ds = ds_cfg
        self.enhance_model = enhance_model
        self.joint = joint
        self.beamform_utterance = beamform_utterance
        self.power_iters = power_iters
        self.device = next(miso1_model.parameters()).device
        self.decode = make_full_array_decode(
            miso1_model, ds_cfg.num_ch_utilize, ds_cfg.ref_ch
        )

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

    def _to_device(self, pieces: np.ndarray) -> torch.Tensor:
        """[Nb, chunk, C] host chunks -> [Nb, C, chunk] float32 on the
        device."""
        x = np.ascontiguousarray(pieces.transpose(0, 2, 1))
        return profiling.to_device(x, self.device, torch.float32)

    @torch.inference_mode()
    def process(self, mix_wave: np.ndarray,
                refs: np.ndarray | None = None) -> UtteranceResult:
        """mix_wave: [samples, C] float32; refs: [S, samples] or None."""
        with profiling.span("serve.request"):
            return self._process(mix_wave, refs)

    def _process(self, mix_wave, refs):
        chunk = self.ds.chunk_samples
        pieces, gap = split_chunks(mix_wave, chunk)       # [N, chunk, C]
        n = pieces.shape[0]
        nb = _next_bucket(n)
        pieces_t = self._to_device(_pad_bucket(pieces, nb))  # [Nb, C, chunk]
        mix = stft_scaled(pieces_t, self.stft_cfg)           # [Nb, C, T, F]
        ref_stft = None
        if refs is not None:
            ref_pieces, _ = split_chunks(np.ascontiguousarray(refs.T), chunk)
            ref_stft = stft_scaled(
                self._to_device(_pad_bucket(ref_pieces, nb)), self.stft_cfg)
        full, miso1_ref = self._decode_align(mix, ref_stft)

        out_len = mix_wave.shape[0]
        separated = self._stitch(miso1_ref, n, gap, out_len)  # [S, samples]

        beamformed = enhanced = None
        if not self.beamform_utterance:
            if self.enhance_model is not None:
                # chunk mode (tester.py:453-543): MVDR per split
                bf_stft = beamform_sources(full, mix, self.ds.ref_ch,
                                           self.power_iters)  # [Nb, S, T, F]
                beamformed = self._stitch(bf_stft, n, gap, out_len)
                enhanced_stft = self._enhance(mix, miso1_ref, bf_stft)
                enhanced = self._stitch(enhanced_stft, n, gap, out_len)
            # else: separation only (Tester_Separate)
        else:
            # utterance mode (tester.py:340-451); the enhance nets then run
            # per chunk on the re-chunked BF wave
            t_valid = self.stft_cfg.num_frames(out_len)
            bf = self._bf_utt(full, pieces_t, t_valid, out_len)
            if self.enhance_model is None:
                beamformed = self._istft_multi(bf, out_len)
            else:
                bf_wave, enhanced_stft = self._enh_utt(
                    bf, miso1_ref, mix, t_valid, out_len)
                beamformed = profiling.readback(bf_wave[:, :out_len]).numpy()
                enhanced = self._stitch(enhanced_stft, n, gap, out_len)

        scores: dict[str, float] = {}
        if refs is not None:
            for name, est in [("miso1", separated), ("beamform", beamformed),
                              ("enhanced", enhanced)]:
                if est is not None:
                    scores[name] = _pit_si_sdr(est, refs)
        return UtteranceResult(separated, beamformed, enhanced, scores)

    def _stitch(self, spec: torch.Tensor, n: int, gap: int,
                out_len: int) -> np.ndarray:
        """[N(,bucketed), S, T, F] chunk spectrograms -> [S, out_len] wave."""
        chunk = self.ds.chunk_samples
        wav = istft_scaled(spec[:n], self.stft_cfg, chunk)  # [N, S, chunk]
        wav = profiling.readback(wav).numpy().transpose(1, 0, 2)  # [S,N,chunk]
        return np.stack(
            [merge_chunks(w[:, :, None], gap)[:, 0] for w in wav]
        )[:, :out_len]

    def _istft_multi(self, spec: torch.Tensor, out_len: int) -> np.ndarray:
        """[S, T_b, F] bucket-padded whole-utterance spectrogram ->
        [S, out_len] wave, synthesized from exactly the frames of the
        out_len-sample scipy framing: bucket-pad frames would deflate the
        last hop's samples through the window-energy envelope."""
        t_valid = min(spec.shape[-2], self.stft_cfg.num_frames(out_len))
        chunk = self.ds.chunk_samples
        bucket = _next_bucket(max(1, -(-out_len // chunk))) * chunk
        wav = istft_scaled_masked(spec, t_valid, self.stft_cfg, bucket)
        return profiling.readback(wav[..., :out_len]).numpy()

    def _bf_utt(self, full, pieces_t, t_valid: int, out_len: int):
        """Utterance-mode MVDR: per-chunk iSTFT -> stitch (a reshape of the
        bucketed chunk layout) -> zero the samples past ``out_len`` (the gap
        trim) -> masked whole-utterance re-STFT -> one SCM over the real
        frames -> MVDR.  [Nb, S, C, T, F] -> [S, T_utt, F].

        The re-STFT's frames past ``t_valid`` are zeroed: the bucket's zero
        pad adds a frame straddling the real tail that the reference's
        exact-length framing never has, and it would skew the SCM."""
        cfg, chunk = self.stft_cfg, self.ds.chunk_samples
        est_wav = istft_scaled(full, cfg, chunk)         # [Nb, S, C, chunk]
        nb, s, c, _ = est_wav.shape
        smask = (torch.arange(nb * chunk, device=full.device)
                 < out_len).to(est_wav.dtype)
        stitched = est_wav.permute(1, 2, 0, 3).reshape(s, c, nb * chunk)
        mix_full = pieces_t.permute(1, 0, 2).reshape(c, nb * chunk)
        src = mask_frames(stft_scaled(stitched * smask, cfg), t_valid)
        mixs = mask_frames(stft_scaled(mix_full * smask, cfg), t_valid)
        return mvdr_beamform(src, mixs[None], ref_ch=self.ds.ref_ch,
                             power_iters=self.power_iters)

    def _enh_utt(self, bf, miso1_ref, mix_stft, t_valid: int, out_len: int):
        """Utterance-mode enhance tail: masked iSTFT of the utterance-grid
        BF -> zero past ``out_len`` -> re-chunk (reshape) -> chunk-grid
        STFT -> MISO2/3.  Returns (BF wave [S, Nb*chunk], enhanced
        [Nb, S, T, F])."""
        chunk = self.ds.chunk_samples
        nb = mix_stft.shape[0]
        bf_wave = istft_scaled_masked(bf, t_valid, self.stft_cfg, nb * chunk)
        smask = torch.arange(nb * chunk, device=bf.device) < out_len
        bf_wave = bf_wave * smask.to(bf_wave.dtype)
        s = bf_wave.shape[0]
        bf_chunks = bf_wave.reshape(s, nb, chunk).transpose(0, 1)
        bf_stft = stft_scaled(bf_chunks, self.stft_cfg)  # [Nb, S, T, F]
        return bf_wave, self._enhance(mix_stft, miso1_ref, bf_stft)

    def _enhance(self, mix_stft, miso1_ref, bf_stft):
        """Per-chunk MISO2/3 on [N, S, T, F] stacks, all chunks (and, for
        MISO3, speakers) in one forward; every chunk sits on the exact 4 s
        frame grid, as in the reference's per-split Tester_Enhance."""
        return enhance(self.enhance_model, mix_stft, miso1_ref, bf_stft,
                       self.joint)

    def evaluate_corpus(
        self,
        specs,
        out_dir: str | Path,
        write: bool = True,
        max_utts: int | None = None,
        wav_subtype: str = "PCM_16",
        workers: int = 2,
    ) -> dict[str, float]:
        """Run over extraction specs (objects with ``utt_id``, ``mix_path``
        and ``source_paths``), write per-stage wavs as the reference testers
        do (``<stage>/<utt>_<spk>.wav``, tester.py:181-183), return the mean
        per-stage SI-SDR.  ``wav_subtype="PCM_24"`` gives the reference's
        on-disk sample format (tester.py:157).

        ``workers`` > 1 runs utterances in a thread pool, so one
        utterance's host half (wav reads, stitching, scoring, wav writes)
        overlaps another's device half; results are aggregated in spec
        order and each utterance's numbers do not change."""
        out = Path(out_dir)

        def one(spec):
            mix, fs = read_wav(spec.mix_path)
            refs = np.stack([read_wav(p)[0] for p in spec.source_paths])
            res = self.process(mix, refs)
            if write:
                for stage, est in [("MISO1", res.separated),
                                   ("Beamforming", res.beamformed),
                                   ("Enhanced", res.enhanced)]:
                    if est is None:
                        continue
                    for sp in range(est.shape[0]):
                        write_wav(out / stage / f"{spec.utt_id}_{sp}.wav",
                                  est[sp], fs, subtype=wav_subtype)
            return res.si_sdr

        todo = specs[:max_utts]
        if workers > 1:
            from concurrent.futures import ThreadPoolExecutor

            with ThreadPoolExecutor(max_workers=workers) as tp:
                results = list(tp.map(one, todo))
        else:
            results = [one(s) for s in todo]
        agg: dict[str, list[float]] = {}
        for scores in results:
            for k, v in scores.items():
                agg.setdefault(k, []).append(v)
        return {k: float(np.mean(v)) for k, v in agg.items()}


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
