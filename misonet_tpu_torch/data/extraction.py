"""Offline dataset extraction (ETL): wav corpora -> chunked array shards (a
copy of misonet_tpu/data/extraction.py: the same shards, byte for byte).

Reference counterparts: main_smswsj / chunkSplit (dataloader/SMS_WSJ.py:31-312)
and the REVERB_2MIX / RIR_mixing variants (dataloader/REVERB_2MIX.py,
RIR_mixing.py).  Same contract — each training example is a dict with the
mixture and per-speaker reference signals chunked to 4 s windows at 2 s hop —
but stored as compressed .npz shards instead of per-chunk pickles, and
parallelized per host (each process extracts an interleaved slice of the
utterance list; SURVEY.md §2.10 item 5) with a local process pool replacing
the reference's Pool(cpu_count()) (SMS_WSJ.py:276-280).
"""

from __future__ import annotations

import dataclasses
import multiprocessing
import os
from concurrent.futures import ProcessPoolExecutor, ThreadPoolExecutor
from pathlib import Path

import numpy as np

from misonet_tpu_torch.data.wavio import read_wav
from misonet_tpu_torch.ops.chunk import train_chunks


@dataclasses.dataclass(frozen=True)
class ExtractionSpec:
    """One utterance to extract: mixture wav + per-speaker source wavs.

    For SMS-WSJ the mixture is ``observation/<utt>.wav`` and sources are
    ``speech_source/<utt>_0.wav`` / ``_1.wav`` (SMS_WSJ.py:283-312).

    ``companions`` are extra aligned signals stored alongside under their
    key — the reference's early/tail/noise (and precomputed MISO1/
    Beamforming) companion wavs selected by ``save_flag``
    (SMS_WSJ.py:44-69, :102-127); keys follow its pickle contract
    (``early1``/``tail1``/``noise``/``MISO1_1``/``Beamforming_1``...).
    Unlike the reference's six parallel pickle dirs, companions land in
    the same .npz shard as the mixture/refs."""

    utt_id: str
    mix_path: str
    source_paths: tuple[str, ...]
    companions: tuple[tuple[str, str], ...] = ()


def discover_smswsj(
    observation_dir: str | Path,
    source_dir: str | Path,
    num_spks: int = 2,
    early_dir: str | Path | None = None,
    tail_dir: str | Path | None = None,
    noise_dir: str | Path | None = None,
) -> list[ExtractionSpec]:
    """Walk an SMS-WSJ-layout corpus directory into extraction specs.

    ``early_dir``/``tail_dir`` hold per-speaker companions named like the
    sources (``<utt>_<s>.wav``); ``noise_dir`` holds ``<utt>.wav``
    (reference SMS_WSJ.py:283-312 path construction).  Companions are
    included when the directory is given and the file exists."""
    specs = []
    for mix_path in sorted(Path(observation_dir).glob("*.wav")):
        utt = mix_path.stem
        sources = tuple(
            str(Path(source_dir) / f"{utt}_{s}.wav") for s in range(num_spks)
        )
        if not all(Path(s).exists() for s in sources):
            continue
        comps = []
        for key, d in (("early", early_dir), ("tail", tail_dir)):
            if d is not None:
                for s in range(num_spks):
                    p = Path(d) / f"{utt}_{s}.wav"
                    if p.exists():
                        comps.append((f"{key}{s + 1}", str(p)))
        if noise_dir is not None:
            p = Path(noise_dir) / f"{utt}.wav"
            if p.exists():
                comps.append(("noise", str(p)))
        specs.append(ExtractionSpec(utt, str(mix_path), sources, tuple(comps)))
    return specs


def extract_utterance(
    spec: ExtractionSpec, out_dir: str | Path, chunk: int, least: int,
    use_native: bool | None = None,
) -> int:
    """Chunk one utterance into .npz shards {mix [S,C], ref1 [S], ref2 [S]}
    (the reference's per-chunk pickle dict contract, SMS_WSJ.py:147-226).
    Returns the number of chunks written.

    ``use_native`` routes wav decode through the threaded C++ library
    (native/misonet_native.cpp via data/native.py) — None auto-detects;
    the reference's equivalent decode is librosa inside a
    multiprocessing.Pool (SMS_WSJ.py:18-29, :276-280)."""
    from misonet_tpu_torch.data import native

    if use_native is None:
        use_native = native.available()
    read = native.read_wav_native if use_native else read_wav
    mix, _ = read(spec.mix_path)
    if mix.ndim == 1:
        mix = mix[:, None]
    refs = []
    for p in spec.source_paths:
        r, _ = read(p)
        refs.append(r[:, 0] if r.ndim > 1 else r)

    mix_chunks = train_chunks(mix, chunk, least)
    ref_chunks = [train_chunks(r, chunk, least) for r in refs]
    comp_chunks = []
    for key, p in spec.companions:
        c, _ = read(p)
        # per-speaker companions (early/tail) are the ref-mic image ->
        # mono; noise keeps its channels (reference SMS_WSJ.py:105,:122)
        if c.ndim > 1 and key != "noise":
            c = c[:, 0]
        comp_chunks.append((key, train_chunks(c, chunk, least)))

    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    for i, mc in enumerate(mix_chunks):
        payload = {"mix": mc.astype(np.float32)}
        for s, rc in enumerate(ref_chunks):
            payload[f"ref{s + 1}"] = rc[i].astype(np.float32)
        for key, cc in comp_chunks:
            payload[key] = cc[i].astype(np.float32)
        np.savez(out / f"{spec.utt_id}_chunk{i:03d}.npz", **payload)
    return len(mix_chunks)


# Utterances per native pack_shards call: bounds peak memory to roughly
# batch * chunks/utt * chunk * C * 4 bytes per role (all roles resident
# during a batch) instead of the whole host slice — ~64 SMS-WSJ-sized
# utterances keep the packer under a few GB on any corpus size.
_NATIVE_BATCH_UTTS = 64


def _extract_corpus_native(
    specs: list[ExtractionSpec], out_dir: str | Path, chunk: int, least: int
) -> int | None:
    """Batch fast path: decode + chunk the slice with the threaded native
    packer (native/misonet_native.cpp::pack_shards) in bounded batches of
    ``_NATIVE_BATCH_UTTS`` utterances — one pack_shards call per role per
    batch, shards written (and buffers released) before the next batch, so
    peak memory is independent of corpus size.  Requires the native
    library and uniform per-role channel counts; returns None to fall
    back to the per-utterance path.

    Reference equivalent: librosa decode inside Pool(cpu_count())
    (SMS_WSJ.py:276-280) — here each batch's file list is fanned across
    C++ decode threads and lands in one preallocated
    [batch_chunks, chunk, C] buffer with no per-chunk python churn."""
    from misonet_tpu_torch.data import native

    if not native.available() or not specs:
        return None
    total_written = 0
    for lo in range(0, len(specs), _NATIVE_BATCH_UTTS):
        n = _extract_native_batch(
            specs[lo : lo + _NATIVE_BATCH_UTTS], out_dir, chunk, least
        )
        if n is None:
            return None
        total_written += n
    return total_written


def _extract_native_batch(
    specs: list[ExtractionSpec], out_dir: str | Path, chunk: int, least: int
) -> int | None:
    """One bounded batch of the native fast path (see _extract_corpus_native)."""
    from misonet_tpu_torch.data import native

    num_spks = len(specs[0].source_paths)
    comp_keys = tuple(k for k, _ in specs[0].companions)
    if any(
        len(s.source_paths) != num_spks
        or tuple(k for k, _ in s.companions) != comp_keys
        for s in specs
    ):
        return None

    roles: dict[str, list[str]] = {"mix": [s.mix_path for s in specs]}
    for sp in range(num_spks):
        roles[f"ref{sp + 1}"] = [s.source_paths[sp] for s in specs]
    for j, key in enumerate(comp_keys):
        roles[key] = [s.companions[j][1] for s in specs]

    packed: dict[str, np.ndarray] = {}
    counts = None
    for key, paths in roles.items():
        try:
            # one python-side header pass per role (uniformity + counts);
            # pack_shards re-reads headers internally for its offsets —
            # its C ABI takes offsets it derives itself
            infos = [native.wav_info(p) for p in paths]
        except OSError:
            return None
        chs = {ch for _, ch, _ in infos}
        if len(chs) != 1:
            return None
        ch = chs.pop()
        if key == "mix":
            counts = [
                native.chunk_count(frames, chunk, least)
                for frames, _, _ in infos
            ]
        arr = native.pack_shards(paths, chunk, least, ch)
        if key != "mix" and key != "noise" and arr.shape[-1] > 1:
            arr = arr[:, :, 0]      # per-speaker roles keep the ref mic
        elif key != "mix" and arr.shape[-1] == 1:
            arr = arr[:, :, 0]
        packed[key] = arr

    total = sum(counts)
    if any(p.shape[0] != total for p in packed.values()):
        return None                 # role lengths disagree — let the
                                    # per-utterance path raise precisely
    out = Path(out_dir)
    out.mkdir(parents=True, exist_ok=True)
    jobs = []
    off = 0
    for spec, cnt in zip(specs, counts):
        for i in range(cnt):
            jobs.append((spec.utt_id, i, off + i))
        off += cnt

    def _write(job):
        utt, i, row = job
        np.savez(
            out / f"{utt}_chunk{i:03d}.npz",
            **{key: packed[key][row] for key in roles},
        )

    # shard writing is file IO — np.savez releases the GIL in write();
    # threads overlap it like the reference's Pool overlaps librosa+pickle
    with ThreadPoolExecutor(max_workers=min(8, os.cpu_count() or 1)) as tp:
        list(tp.map(_write, jobs))
    return total


def extract_corpus(
    specs: list[ExtractionSpec],
    out_dir: str | Path,
    chunk: int,
    least: int,
    host_index: int = 0,
    host_count: int = 1,
    workers: int = 0,
    use_native: bool | None = None,
) -> int:
    """Extract a corpus slice.  Each host takes utterances
    ``specs[host_index::host_count]`` (per-host input sharding); within a
    host a process pool fans out utterances when ``workers`` > 1.
    ``use_native=True`` routes the whole slice through the C++ batch
    packer (native pack_shards): one threaded decode+chunk pass per role
    into preallocated buffers, then threaded shard writes.  Byte-identical
    output (tests/test_native.py); measured on this 2-CPU container the
    ProcessPool python path is still faster end-to-end (shard WRITING
    dominates and fans across processes), so the default (None = auto)
    keeps the pool and only auto-enables the native wav *decoder* inside
    it — the packer is for decode-bound many-core hosts."""
    mine = specs[host_index::host_count]
    if not mine:
        return 0
    if use_native is True:
        from misonet_tpu_torch.data import native

        if not native.available():
            raise RuntimeError(
                "use_native=True but the native library is not built "
                "(make -C native)"
            )
        n = _extract_corpus_native(mine, out_dir, chunk, least)
        if n is not None:
            return n
        # non-uniform roles / length mismatch: fall through to the
        # per-utterance path, which handles (or reports) them precisely
        import warnings

        warnings.warn(
            "use_native=True: corpus is not role-uniform; falling back to "
            "the per-utterance extraction path",
            stacklevel=2,
        )
    if workers and workers > 1:
        # spawned workers: the caller may hold threads (torch, a Batcher)
        ctx = multiprocessing.get_context("spawn")
        with ProcessPoolExecutor(max_workers=min(workers, len(mine)),
                                 mp_context=ctx) as pool:
            counts = list(
                pool.map(
                    _extract_one,
                    [(s, str(out_dir), chunk, least, use_native) for s in mine],
                )
            )
        return sum(counts)
    return sum(
        extract_utterance(s, out_dir, chunk, least, use_native) for s in mine
    )


def _extract_one(args) -> int:
    spec, out_dir, chunk, least, use_native = args
    return extract_utterance(spec, out_dir, chunk, least, use_native)
