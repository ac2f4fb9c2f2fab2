"""The measured program, misonet_tpu_torch, built from a configuration file
through its own entry points, and given the weights the benchmark made.

The same state dicts go to the plain reference, which builds its own nets
(``reference/nets.py``)."""

from __future__ import annotations

import torch

from benchmark import traffic
from benchmark.reference.nets import MISONet as RefNet
from benchmark.reference.weights import make_state_dict


def ref_net(cfg: dict, name: str, device=None) -> RefNet:
    """The plain float32 net ``name`` (miso1 or miso3) of ``cfg``."""
    ds = cfg["dataset"]
    if name == "miso1":
        args = (ds["num_ch"], ds["num_spks"])
    else:
        args = (ds["num_ch"] + 2, 1)
    with torch.device(device or "meta"):
        return RefNet(cfg["model"], *args)


def weights(cfg: dict, seed: int, device) -> dict[str, dict]:
    """{net name: state dict} from the seed, made on ``device``."""
    return {name: make_state_dict(ref_net(cfg, name), traffic.torch_seed(
        seed, "weights_" + name), device) for name in cfg["nets"]}


def configs(cfg: dict, quant_int8: bool = False):
    """The program's (ModelConfig, StftConfig, DatasetConfig) for ``cfg``."""
    from misonet_tpu_torch.config import DatasetConfig, ModelConfig, StftConfig

    m, st, ds = cfg["model"], cfg["stft"], cfg["dataset"]
    model = ModelConfig(
        num_bottleneck=m["num_bottleneck"], en_channels=tuple(m["en_channels"]),
        de_channels=tuple(m["de_channels"]), norm_type=m["norm_type"],
        tcn_repeats=m["tcn_repeats"], tcn_blocks=m["tcn_blocks"],
        tcn_channels=m["tcn_channels"], compute_dtype=cfg["precision"],
        flat_dense=m["flat_dense"], quant_int8=quant_int8)
    stft = StftConfig(fs=st["fs"], window="hann", length=st["length"],
                      overlap=st["overlap"])
    dataset = DatasetConfig(
        fs=ds["fs"], chunk_time=ds["chunk_time"], least_time=ds["least_time"],
        num_spks=ds["num_spks"], num_ch=ds["num_ch"], ref_ch=ds["ref_ch"],
        num_ch_utilize=ds["num_ch"])
    return model, stft, dataset


def nets(cfg: dict, sd: dict, device, quant_int8: bool = False) -> dict:
    """The program's nets of ``cfg`` on ``device``, holding ``sd``."""
    from misonet_tpu_torch.models import make_miso1, make_miso3

    model, _, ds = configs(cfg, quant_int8)
    out = {}
    for name in cfg["nets"]:
        if name == "miso1":
            net = make_miso1(model, ds.num_ch, ds.num_spks, device=device)
        else:
            net = make_miso3(model, ds.num_ch, device=device)
        net.load_state_dict(sd[name])
        out[name] = net
    return out


def rel_err(prog, ref) -> float:
    """Largest over speakers of ||prog - ref|| / ||ref||; ``prog`` and
    ``ref`` are [S, samples] arrays."""
    import numpy as np

    prog = np.asarray(prog, np.float64)
    ref = np.asarray(ref, np.float64)
    n = min(prog.shape[-1], ref.shape[-1])
    num = np.sqrt(((prog[..., :n] - ref[..., :n]) ** 2).sum(-1))
    den = np.sqrt((ref[..., :n] ** 2).sum(-1))
    return float((num / np.maximum(den, 1e-30)).max())
