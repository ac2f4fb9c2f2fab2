"""The MISO separation / enhancement networks (misonet_tpu/models/miso.py;
reference model.py: MISO_1 :8-163, MISO_2 :166-278, MISO_3 :282-395).

One parameterized U-Net + TCN (``MISONet``) covers all three reference
models; they differ only in input channel count and output speaker count.
Complex spectrogram in, complex spectrogram out; inside, complex is handled
as stacked real channels (all real, then all imaginary) in NCHW.

On a CUDA input the U-Net body at levels 0-4 and their decoder mirrors runs
fused over the CUDA kernels (``models/flat_dense.py``), forward and, under
autograd, backward; elsewhere, and on the CPU, the plain modules run.  Both
paths use the same parameters.  The factories build the model on the card
unless the caller asks for another device.
"""

from __future__ import annotations

import torch
import torch.nn as nn

from misonet_tpu_torch.config import ModelConfig
from misonet_tpu_torch.models.blocks import (
    ConvBlock,
    DeconvBlock,
    DenseBlock,
    TemporalConvNet,
    init_parameters,
)
from misonet_tpu_torch.models.flat_dense import (
    DeconvUpFlat,
    DenseBlockFlat,
    Enc0Flat,
    FinalDeconvFlat,
    TrunkDownFlat,
    from_bundle,
    identity_bundle,
    merge_bundles,
    resolve_flat,
)


def check_config(cfg: ModelConfig) -> None:
    """Raise for settings the port does not implement yet (each is a
    ROADMAP item), instead of silently computing something else."""
    if cfg.compute_dtype != "float32":
        raise ValueError(
            f"compute_dtype={cfg.compute_dtype!r}: the PyTorch port computes "
            "in float32 only (bf16 kernel paths are a ROADMAP item); use "
            "ModelConfig(compute_dtype='float32')"
        )
    if cfg.quant_int8:
        raise ValueError(
            "quant_int8=True: the int8 dense_stack decode path is not ported "
            "yet (ROADMAP, TPU kernels still to port)"
        )
    if cfg.sequence_parallel:
        raise NotImplementedError(
            "sequence_parallel=True: parallel/ is not ported yet (ROADMAP)"
        )


class MISONet(nn.Module):
    """U-Net + TCN complex spectral mapping network.

    Input:  complex64 [B, in_channels, T, F]  (F = 129 for the 8 kHz config)
    Output: complex64 [B, num_spks, T, F]
    """

    def __init__(self, cfg: ModelConfig, in_channels: int, num_spks: int = 2):
        super().__init__()
        check_config(cfg)
        self.cfg = cfg
        self.num_spks = num_spks
        nb = cfg.num_bottleneck
        en = list(cfg.en_channels)
        de = list(cfg.de_channels) + [2 * num_spks]
        if len(en) != nb or len(de) != nb + 1:
            raise ValueError(f"channel plan does not match {nb} levels: "
                             f"en={en}, de={cfg.de_channels}")

        c_in = 2 * in_channels
        for i in range(nb):
            stride = (1, 1 if i in (0, nb - 1) else 2)
            if i == 0:
                enc = Enc0Flat(c_in, en[0], act_norm=False)
            elif i <= 4 and stride[1] == 2:
                enc = TrunkDownFlat(c_in, en[i], stride=stride)
            else:
                enc = ConvBlock(c_in, en[i], stride=stride)
            self.add_module(f"enc{i}", enc)
            if i < 5:
                self.add_module(f"enc{i}_dense",
                                DenseBlockFlat(en[i], en[i], en[i]))
            c_in = en[i]

        self.tcn = TemporalConvNet(cfg.tcn_repeats, cfg.tcn_blocks,
                                   cfg.tcn_channels, cfg.norm_type)

        c_x = cfg.tcn_channels
        for i in range(nb):
            cin = c_x + en[nb - 1 - i]
            fused = nb >= 7 and i >= nb - 5
            if i >= 2:
                dense_cls = DenseBlockFlat if fused else DenseBlock
                self.add_module(f"dec{i}_dense",
                                dense_cls(cin, cin // 2, cin))
            if i == nb - 1:
                dec = FinalDeconvFlat(cin, de[i + 1], stride=(1, 1))
            else:
                dec_cls = DeconvUpFlat if fused else DeconvBlock
                dec = dec_cls(cin, de[i + 1], stride=(1, 1 if i == 0 else 2))
            self.add_module(f"dec{i}", dec)
            c_x = de[i + 1]

    def forward(self, mixture: torch.Tensor) -> torch.Tensor:
        if mixture.ndim != 4 or not mixture.is_complex():
            raise ValueError(
                f"expected complex [B, C, T, F], got {mixture.dtype} "
                f"{tuple(mixture.shape)}"
            )
        nb = self.cfg.num_bottleneck
        x_cm = torch.cat([mixture.real, mixture.imag], dim=1)
        x_cm = x_cm.to(torch.float32).contiguous()
        flat = resolve_flat(self.cfg.flat_dense, x_cm, nb=nb)

        # --- encoder: levels 0-4 stay raw tensors + statistics when fused
        skips = []
        x = x_cm
        bundle = None
        for i in range(nb):
            enc = getattr(self, f"enc{i}")
            dense = getattr(self, f"enc{i}_dense", None)
            if flat and i < 5:
                bundle = enc.flat(x_cm) if i == 0 else enc.flat(bundle)
                bundle = dense.flat(bundle)
                skips.append(bundle)
                continue
            if flat and i == 5:
                x = from_bundle(bundle)
            x = enc(x)
            if dense is not None:
                x = dense(x)
            skips.append(x)

        # --- TCN bottleneck ([B, C, T, 1] -> [B, C, T])
        if x.shape[3] != 1:
            raise ValueError(
                f"bottleneck frequency axis must reduce to 1, got "
                f"{x.shape[3]} (input F must be 129 for the default plan)"
            )
        x = self.tcn(x[..., 0])[..., None]

        # --- decoder with skip concatenation (logical when fused)
        for i in range(nb):
            skip = skips[nb - 1 - i]
            dec = getattr(self, f"dec{i}")
            dense = getattr(self, f"dec{i}_dense", None)
            if flat and i >= nb - 5:
                if i == nb - 5:
                    bundle = identity_bundle(x)
                bundle = dense.flat(merge_bundles(bundle, skip))
                if i == nb - 1:
                    x = dec.flat(bundle)
                else:
                    bundle = dec.flat(bundle)
                continue
            x = torch.cat([x, skip], dim=1)
            if dense is not None:
                x = dense(x)
            x = dec(x)

        real, imag = torch.chunk(x, 2, dim=1)
        return torch.complex(real, imag)


def _build(cfg, in_channels, num_spks, device, generator) -> MISONet:
    model = MISONet(cfg, in_channels, num_spks)
    if generator is None:
        generator = torch.Generator().manual_seed(0)
    init_parameters(model, generator)
    return model.to(device)


def make_miso1(cfg: ModelConfig, num_mics: int = 6, num_spks: int = 2, *,
               device="cuda", generator: torch.Generator | None = None):
    """Separation net: C-mic complex mixture -> num_spks sources at the
    reference mic (reference model.py:8-111).  Parameters are drawn from
    ``generator`` (a CPU ``torch.Generator``; seed 0 when None)."""
    return _build(cfg, num_mics, num_spks, device, generator)


def make_miso2(cfg: ModelConfig, num_mics: int = 6, num_spks: int = 2, *,
               device="cuda", generator: torch.Generator | None = None):
    """Joint enhancement net over mixture + per-speaker MISO1 + BF stacks
    (input channels C + 2*num_spks; reference model.py:166-278)."""
    return _build(cfg, num_mics + 2 * num_spks, num_spks, device, generator)


def make_miso3(cfg: ModelConfig, num_mics: int = 6, *, device="cuda",
               generator: torch.Generator | None = None):
    """Per-speaker enhancement net over mixture + 1 MISO1 + 1 BF channel
    (input channels C + 2; reference model.py:282-395)."""
    return _build(cfg, num_mics + 2, 1, device, generator)


def enhance_input(mixture: torch.Tensor, miso1: torch.Tensor,
                  bf: torch.Tensor) -> torch.Tensor:
    """Stack the enhancement-net conditioning channels: mixture [B, C, T, F]
    + MISO1 estimates [B, S, T, F] + beamformed estimates [B, S, T, F]
    -> [B, C+2S, T, F], in the JAX package's canonical order."""
    return torch.cat([mixture, miso1, bf], dim=1)
