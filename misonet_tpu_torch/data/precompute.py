"""Precompute MISO1 / beamformer outputs for enhancement training
(misonet_tpu/data/precompute.py).

The reference supports two enhancement-training data modes: compute MISO1 +
MVDR inside the DataLoader per item, or load outputs precomputed by a
test-mode pass (``load_MISO1_Output`` / ``load_MVDR_Output`` flags,
NN_BSS.yml:171-172; save path via Tester save_flag, SMS_WSJ.py:47-54;
loading at data.py:133-145, :190-199).

This module is the save side, on the device and batched: run the
frozen-MISO1 full-array decode + MVDR (all speakers in one
``mvdr_weights`` launch) over a shard directory and write companion
``<shard>.feat.npz`` files holding the ref-channel MISO1 and beamformed
complex spectrograms.  ``ShardDataset`` picks the companions up via
``with_features=True`` and ``EnhanceTrainer`` can then skip its feature
step.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from misonet_tpu_torch.config import DatasetConfig, StftConfig
from misonet_tpu_torch.data.dataset import ShardDataset
from misonet_tpu_torch.inference.cascade import beamform_sources
from misonet_tpu_torch.inference.separate import make_full_array_decode
from misonet_tpu_torch.ops.stft import stft_scaled


def precompute_enhance_features(
    miso1_model,
    shard_dir: str | Path,
    stft_cfg: StftConfig,
    ds_cfg: DatasetConfig,
    batch_size: int = 8,
    host_index: int = 0,
    host_count: int = 1,
) -> int:
    """Write <shard>.feat.npz companions (miso1 [S,T,F], bf [S,T,F]
    complex64) for every shard.  ``miso1_model`` is a port ``MISONet``
    holding its parameters (the JAX function takes them apart).  Returns
    the number of files written."""
    ds = ShardDataset(shard_dir, ds_cfg.num_spks, host_index, host_count)
    decode = make_full_array_decode(
        miso1_model, ds_cfg.num_ch_utilize, ds_cfg.ref_ch
    )
    device = next(miso1_model.parameters()).device

    @torch.inference_mode()
    def features(idxs):
        mix_wave = torch.from_numpy(np.stack([ds[i]["mix"] for i in idxs]))
        mix = stft_scaled(mix_wave.to(device).transpose(1, 2), stft_cfg)
        full = decode(mix)
        bf = beamform_sources(full, mix, ds_cfg.ref_ch)
        return full[:, :, ds_cfg.ref_ch].cpu().numpy(), bf.cpu().numpy()

    # full batches, then the tail (partial batch) one by one, as in JAX
    whole = len(ds) - len(ds) % batch_size
    groups = [list(range(s, s + batch_size))
              for s in range(0, whole, batch_size)]
    groups += [[i] for i in range(whole, len(ds))]
    written = 0
    for idxs in groups:
        miso1, bf = features(idxs)
        for j, i in enumerate(idxs):
            np.savez(ds.files[i].with_suffix(".feat.npz"), miso1=miso1[j],
                     bf=bf[j])
            written += 1
    return written
