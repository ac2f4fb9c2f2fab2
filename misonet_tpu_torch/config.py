"""The configuration dataclasses of the port (a copy of those in
misonet_tpu/config.py that the port uses).

Fields and defaults are the JAX package's, verbatim, so the same values
mean the same model, optimizer and run; the port keeps its own copy so that
it imports nothing of the JAX package.  The option the port does not
implement yet (``sequence_parallel``) is refused where a model is built
(``models.miso.check_config``).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class StftConfig:
    """STFT/iSTFT parameters (reference NN_BSS.yml:72-88).

    The reference uses scipy.signal.stft with a periodic Hann window and
    rescales by ``1/hann.sum()`` for MATLAB-compatible scaling
    (data.py:37-38,78).
    """

    fs: int = 8000
    window: str = "hann"
    length: int = 256          # nperseg -> F = length//2 + 1 = 129 bins
    overlap: int = 192         # noverlap -> hop = 64

    @property
    def hop(self) -> int:
        return self.length - self.overlap

    @property
    def num_bins(self) -> int:
        return self.length // 2 + 1

    def num_frames(self, num_samples: int) -> int:
        """Frame count scipy.signal.stft produces for ``num_samples`` input
        (boundary='zeros' pads length//2 on both ends; padded=True pads the
        tail to a whole number of hops)."""
        padded = num_samples + self.length  # length//2 both sides
        extra = (-(padded - self.length)) % self.hop
        return (padded + extra - self.length) // self.hop + 1


@dataclasses.dataclass(frozen=True)
class DatasetConfig:
    """Dataset geometry (reference NN_BSS.yml:32-70)."""

    name: str = "SMS_WSJ"
    fs: int = 8000
    chunk_time: float = 4.0     # seconds per training chunk
    least_time: float = 2.0     # min usable length; also the chunk hop
    num_spks: int = 2
    num_ch: int = 6
    ref_ch: int = 0
    num_ch_utilize: int = 6     # channel subsampling (data.py:81)
    root_dir: str = ""
    pickle_dir: str = ""
    dev_pickle_dir: str = ""
    tr_file: str = "train_si284"
    dev_file: str = "cv_dev93"
    test_file: str = "test_eval92"
    # Corpus sub-directory names (reference NN_BSS.yml:37-43) and the
    # save_flag gates (:47-54) for companion signals stored with each chunk.
    mix_subdir: str = "observation"
    clean_subdir: str = "speech_source"
    early_subdir: str = "early"
    tail_subdir: str = "tail"
    noise_subdir: str = "noise"
    save_early: bool = False
    save_tail: bool = False
    save_noise: bool = False

    @property
    def chunk_samples(self) -> int:
        return int(self.chunk_time * self.fs)

    @property
    def least_samples(self) -> int:
        return int(self.least_time * self.fs)


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """MISO U-Net plan (reference NN_BSS.yml:114-135, model.py:9-38).

    ``en_channels``/``de_channels`` exclude the input/output channel counts,
    which are derived from mics/speakers exactly as the reference does
    (model.py:16-17, :173-174, :290-291).
    """

    num_bottleneck: int = 7
    en_channels: Sequence[int] = (24, 32, 32, 32, 32, 64, 128)
    de_channels: Sequence[int] = (128, 64, 32, 32, 32, 32, 24)
    norm_type: str = "IN"
    tcn_repeats: int = 2        # R (model.py:31)
    tcn_blocks: int = 7         # X, dilations 2^0..2^6
    tcn_channels: int = 128
    # Conv compute precision: "bfloat16" (activations stored in bf16,
    # f32 accumulation and statistics) or "float32"; parameters stay f32.
    compute_dtype: str = "bfloat16"
    # Run the U-Net body at levels 0-4 and their decoder mirrors over the
    # fused CUDA kernels (models/flat_dense.py).  "auto": on a CUDA input
    # with at least 7 levels; True forces it (raising where it cannot
    # run); False runs the plain modules.
    flat_dense: bool | str = "auto"
    # int8 DenseBlock decode on the fused path of a bfloat16 model
    # (inference only; ignored in float32 and by the plain modules).
    quant_int8: bool = False
    # Sequence-parallel TCN over a device mesh (not ported yet: refused).
    sequence_parallel: bool = False


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Adam + plateau schedule (reference NN_BSS.yml:181-191, run.py:215-223)."""

    name: str = "adam"
    lr: float = 1e-3
    weight_decay: float = 0.0
    clipping: bool = False
    max_norm: float = 5.0
    # Skip updates with non-finite grads (train/state.py, the port of
    # optax.apply_if_finite) in place of the reference's pdb-based NaN
    # guards (model.py:109-110).
    guard_nans: bool = True
    max_consecutive_nan_steps: int = 5
    scheduler: str = "plateau"
    plateau_factor: float = 0.5
    plateau_patience: int = 3
    min_lr: float = 5e-6


@dataclasses.dataclass(frozen=True)
class TrainerConfig:
    """Training-loop settings (reference NN_BSS.yml:139-172)."""

    epochs: int = 100
    batch_size: int = 20
    early_stop: bool = True
    early_stop_patience: int = 10
    print_freq: int = 10
    save_folder: str = "model_result/misonet_tpu"
    checkpoint_every: int = 5
    resume: str = ""            # checkpoint path to resume from
    miso1_checkpoint: str = ""  # frozen MISO1 for enhancement training
    load_miso1_output: bool = False
    load_mvdr_output: bool = False
    # over-estimation penalty (the reference's loss_uPIT_v1 with its
    # commented per-epoch schedule alpha=(epoch+1)*0.03, trainer.py:176-178):
    # 0.0 disables (the reference's effective default); >0 trains with
    # loss_upit_overest at alpha = (epoch+1) * overest_alpha.
    overest_alpha: float = 0.0


__all__ = ["DatasetConfig", "ModelConfig", "OptimizerConfig", "StftConfig",
           "TrainerConfig"]
