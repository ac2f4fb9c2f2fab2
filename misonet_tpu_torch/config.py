"""The configuration of the port (a copy of misonet_tpu/config.py).

Fields and defaults are the JAX package's, verbatim, and :func:`load_yaml`
reads the same reference-layout YAML files into the same values, so the
same file means the same model, optimizer and run; the port keeps its own
copy so that it imports nothing of the JAX package.  What the port does
not implement yet is refused: ``sequence_parallel`` where a model is built
(``models.miso.check_config``), more than one device in ``MeshConfig``
where a ``Config`` is made (the port runs on one card; ``parallel/`` is
not ported).  :class:`TFGridNetConfig` is the port's own: the JAX package
has no TF-GridNet, and its YAML reader does not know the ``network`` key.
"""

from __future__ import annotations

import dataclasses
from pathlib import Path
from typing import Any, Sequence


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
class TFGridNetConfig:
    """TF-GridNet as a MISO1 separator (Wang et al., TASLP 31 (2023),
    arXiv:2211.12433).  Field names and defaults are those of ESPnet's
    ``TFGridNet`` separator (espnet2/enh/separator/tfgridnet_separator.py);
    a YAML's ``MISO_1`` section selects it with ``network: TFGridNet``.

    ``compute_dtype`` picks the activation precision as in
    :class:`ModelConfig`; parameters stay float32."""

    n_layers: int = 6               # B, the number of GridNet blocks
    emb_dim: int = 48               # D
    emb_ks: int = 4                 # I, the unfold's kernel
    emb_hs: int = 1                 # J, the unfold's stride
    lstm_hidden_units: int = 192    # H, each direction
    attn_n_head: int = 4            # L
    attn_approx_qk_dim: int = 512   # E = ceil(512 / F) per head
    eps: float = 1e-5
    n_fft: int = 256                # F = n_fft // 2 + 1 bins (the STFT's length)
    compute_dtype: str = "bfloat16"


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


@dataclasses.dataclass(frozen=True)
class MeshConfig:
    """Device-mesh / parallelism settings (new capability; reference is
    single-GPU, run.py:68)."""

    data_axis: str = "data"
    num_devices: int = 0        # 0 -> use all visible devices


@dataclasses.dataclass(frozen=True)
class Config:
    stft: StftConfig = StftConfig()
    dataset: DatasetConfig = DatasetConfig()
    miso1: ModelConfig | TFGridNetConfig = ModelConfig()
    miso2: ModelConfig = ModelConfig()
    miso3: ModelConfig = ModelConfig()
    optimizer: OptimizerConfig = OptimizerConfig()
    trainer_sp: TrainerConfig = TrainerConfig()
    trainer_en: TrainerConfig = TrainerConfig()
    mesh: MeshConfig = MeshConfig()

    def __post_init__(self):
        if self.mesh.num_devices < 0:
            raise ValueError(f"mesh.num_devices={self.mesh.num_devices}: a "
                             "device count is 0 (all) or more")


def _model_from_yaml(d: dict[str, Any],
                     stft: StftConfig) -> ModelConfig | TFGridNetConfig:
    if d.get("network", "MISONet") == "TFGridNet":
        keys = {f.name for f in dataclasses.fields(TFGridNetConfig)}
        unknown = set(d) - keys - {"network"}
        if unknown:
            raise ValueError(f"TFGridNet takes no {sorted(unknown)}")
        if d.get("n_fft", stft.length) != stft.length:
            raise ValueError(f"TFGridNet n_fft {d['n_fft']} is not the STFT's "
                             f"length {stft.length}")
        return TFGridNetConfig(**{k: v for k, v in d.items() if k in keys}
                               | {"n_fft": stft.length})
    if d.get("network", "MISONet") != "MISONet":
        raise ValueError(f"network {d['network']!r}: MISONet or TFGridNet")
    en = tuple(d.get("en_bottleneck_channels", ModelConfig.en_channels))
    return ModelConfig(
        num_bottleneck=d.get("num_bottleneck", 7),
        en_channels=en,
        de_channels=tuple(d.get("de_bottleneck_channels", ModelConfig.de_channels)),
        norm_type=d.get("norm_type", "IN"),
        # TCN width must match the bottleneck (the reference hard-codes 128
        # == its en[-1], model.py:31); derive it so custom plans stay valid.
        tcn_channels=int(d.get("tcn_channels", en[-1])),
        tcn_repeats=int(d.get("tcn_repeats", 2)),
        tcn_blocks=int(d.get("tcn_blocks", 7)),
        flat_dense=d.get("flat_dense", "auto"),
        quant_int8=bool(d.get("quant_int8", False)),
    )


def load_yaml(path: str | Path) -> Config:
    """Load a reference-layout YAML (NN_BSS.yml style) into a typed Config
    (misonet_tpu/config.py::load_yaml, the same keys and defaults)."""
    import yaml

    with open(path) as f:
        raw = yaml.safe_load(f)

    stft_raw = raw.get("STFT", {})
    stft = StftConfig(
        fs=stft_raw.get("fs", 8000),
        window=stft_raw.get("window", "hann"),
        length=stft_raw.get("length", 256),
        overlap=stft_raw.get("overlap", 192),
    )

    ds_name = "SMS_WSJ" if "SMS_WSJ" in raw else next(iter(raw))
    ds_raw = raw.get("SMS_WSJ", raw.get(ds_name, {})) or {}
    dataset = DatasetConfig(
        name=ds_name,
        fs=ds_raw.get("fs", 8000),
        chunk_time=ds_raw.get("chunk_time", 4.0),
        least_time=ds_raw.get("least_time", 2.0),
        num_spks=ds_raw.get("num_spks", 2),
        num_ch=ds_raw.get("num_ch", 6),
        ref_ch=ds_raw.get("ref_ch", 0),
        num_ch_utilize=ds_raw.get("num_ch_utilize", ds_raw.get("num_ch", 6)),
        root_dir=ds_raw.get("rootdir", ""),
        pickle_dir=ds_raw.get("saved_tr_pickle_dir", ""),
        dev_pickle_dir=ds_raw.get("saved_dt_pickle_dir", ""),
        mix_subdir=ds_raw.get("mix", "observation"),
        clean_subdir=ds_raw.get("clean", "speech_source"),
        early_subdir=ds_raw.get("early", "early"),
        tail_subdir=ds_raw.get("tail", "tail"),
        noise_subdir=ds_raw.get("noise", "noise"),
        save_early=bool((ds_raw.get("save_flag") or {}).get("early", False)),
        save_tail=bool((ds_raw.get("save_flag") or {}).get("tail", False)),
        save_noise=bool((ds_raw.get("save_flag") or {}).get("noise", False)),
    )

    opt_raw = raw.get("optimizer", {})
    sch_raw = raw.get("scheduler", {})
    tr_sp_raw = raw.get("trainer_sp", {})
    tr_en_raw = raw.get("trainer_en", {})
    dl_raw = raw.get("dataloader", {}).get("Train", {})

    optimizer = OptimizerConfig(
        name=str(opt_raw.get("name", "Adam")).lower(),
        lr=float(opt_raw.get("lr", 1e-3)),
        weight_decay=float(opt_raw.get("weight_decay", 0.0)),
        clipping=bool(tr_sp_raw.get("clipping", False)),
        max_norm=float(tr_sp_raw.get("max_norm", 5.0)),
        scheduler=str(sch_raw.get("name", "plateau")),
        plateau_factor=float(sch_raw.get("factor", 0.5)),
        plateau_patience=int(sch_raw.get("patience", 3)),
        min_lr=float(sch_raw.get("min_lr", 5e-6)),
    )

    def _trainer(d: dict[str, Any]) -> TrainerConfig:
        model_load = d.get("model_load", [False, ""])
        return TrainerConfig(
            epochs=int(d.get("epochs", 100)),
            batch_size=int(dl_raw.get("batch_size", 20)),
            early_stop=bool(d.get("early_stop", True)),
            print_freq=int(d.get("print_freq", 10)),
            save_folder=str(d.get("save_folder", "model_result/misonet_tpu")),
            checkpoint_every=int((d.get("check_point") or [True, 5])[1]),
            resume=str(model_load[1]) if model_load and model_load[0] else "",
            miso1_checkpoint=str(d.get("MISO1_path", "")),
            load_miso1_output=bool(d.get("load_MISO1_Output", False)),
            load_mvdr_output=bool(d.get("load_MVDR_Output", False)),
            overest_alpha=float(d.get("overest_alpha", 0.0)),
        )

    return Config(
        stft=stft,
        dataset=dataset,
        miso1=_model_from_yaml(raw.get("MISO_1", {}), stft),
        miso2=_model_from_yaml(raw.get("MISO_2", {}), stft),
        miso3=_model_from_yaml(raw.get("MISO_3", {}), stft),
        optimizer=optimizer,
        trainer_sp=_trainer(tr_sp_raw),
        trainer_en=_trainer(tr_en_raw),
    )


__all__ = ["Config", "DatasetConfig", "MeshConfig", "ModelConfig",
           "OptimizerConfig", "StftConfig", "TFGridNetConfig", "TrainerConfig",
           "load_yaml"]
