"""REVERB_2MIX / RIR-mixed corpora extraction (a copy of
misonet_tpu/data/reverb.py).

Reference counterparts: dataloader/REVERB_2MIX.py (8-channel REVERB corpus,
near/far arrays, .lst scp file lists, :37-187) and dataloader/RIR_mixing.py
(pre-mixed RIR data, :39-195).  Both follow the same chunk-and-shard pattern
as SMS-WSJ; here they reduce to corpus-discovery functions feeding the one
canonical extractor (data/extraction.py::extract_corpus), instead of
the reference's three near-duplicate chunkers.
"""

from __future__ import annotations

from pathlib import Path

from misonet_tpu_torch.data.extraction import ExtractionSpec


def discover_reverb_2mix(
    scp_list: str | Path,
    wave_root: str | Path,
    num_spks: int = 2,
) -> list[ExtractionSpec]:
    """REVERB 2-mix layout: a .lst scp file names utterances relative to
    ``wave_root``; each mixture wav '<utt>.wav' pairs with per-speaker
    sources '<utt>_s<k>.wav' (REVERB_2MIX.py:120-138 conventions)."""
    specs = []
    scp = Path(scp_list)
    entries = (
        [l.strip() for l in scp.read_text().splitlines() if l.strip()]
        if scp.is_file()
        else [p.stem for p in sorted(Path(wave_root).glob("*.wav"))
              if "_s" not in p.stem]
    )
    for utt in entries:
        mix = Path(wave_root) / f"{utt}.wav"
        sources = tuple(
            str(Path(wave_root) / f"{utt}_s{k}.wav") for k in range(num_spks)
        )
        if mix.exists() and all(Path(s).exists() for s in sources):
            specs.append(ExtractionSpec(utt, str(mix), sources))
    return specs


def discover_rir_mixing(
    wave_root: str | Path, num_spks: int = 2
) -> list[ExtractionSpec]:
    """Pre-mixed RIR layout (RIR_mixing.py:115-190): '<utt>_mix.wav' with
    '<utt>_ref<k>.wav' companions."""
    specs = []
    for mix in sorted(Path(wave_root).glob("*_mix.wav")):
        utt = mix.stem[: -len("_mix")]
        sources = tuple(
            str(mix.parent / f"{utt}_ref{k + 1}.wav") for k in range(num_spks)
        )
        if all(Path(s).exists() for s in sources):
            specs.append(ExtractionSpec(utt, str(mix), sources))
    return specs
