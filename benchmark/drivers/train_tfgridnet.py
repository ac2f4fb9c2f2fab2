"""Training TF-GridNet: the session of the ``train`` driver
(``drivers/train.py``) for a configuration whose ``model`` is a TF-GridNet
(``model.network``): ``make_separate_wave_train_step`` (in-graph STFT,
forward, uPIT loss, backward, Adam and the clip) in a closed loop over a
seeded host pool of wave batches, with the same window, traced stretch and
``passes``, the same three checked steps, and the same comparison
(``train.compare``) with the plain reference's float32 steps
(``reference/tfgridnet.py`` through ``reference/training.py``).
"""

from __future__ import annotations

import torch

from benchmark import traffic, work_tfgridnet
from benchmark.drivers import train
from benchmark.reference import tfgridnet as ref

CHECK_STEPS = train.CHECK_STEPS
compare = train.compare


def ref_net(cfg: dict, device=None) -> ref.TFGridNet:
    """The plain float32 TF-GridNet of ``cfg``."""
    ds = cfg["dataset"]
    with torch.device(device or "meta"):
        return ref.TFGridNet(cfg["model"], ds["num_ch"], ds["num_spks"],
                             cfg["stft"]["length"] // 2 + 1)


def weights(cfg: dict, seed: int, device) -> dict[str, dict]:
    """{"miso1": state dict} from the seed, made on ``device``."""
    return {"miso1": ref.make_state_dict(ref_net(cfg), traffic.torch_seed(
        seed, "weights_miso1"), device)}


def model_config(cfg: dict):
    """The program's TFGridNetConfig for ``cfg``."""
    from misonet_tpu_torch.config import TFGridNetConfig

    m = cfg["model"]
    return TFGridNetConfig(
        n_layers=m["n_layers"], emb_dim=m["emb_dim"], emb_ks=m["emb_ks"],
        emb_hs=m["emb_hs"], lstm_hidden_units=m["lstm_hidden_units"],
        attn_n_head=m["attn_n_head"], attn_approx_qk_dim=m["attn_approx_qk_dim"],
        eps=m["eps"], n_fft=cfg["stft"]["length"], compute_dtype=cfg["precision"])


class Session(train.Session):
    def __init__(self, cell: dict, cfg: dict, seed: int, device,
                 half_batch: bool = False):
        from misonet_tpu_torch.config import OptimizerConfig, StftConfig
        from misonet_tpu_torch.models import make_miso1
        from misonet_tpu_torch.train import (create_train_state, make_optimizer,
                                             make_separate_wave_train_step)

        self.cell, self.cfg, self.seed, self.device = cell, cfg, seed, device
        t = cell["traffic"]
        self.sd = weights(cfg, seed, device)
        st, ds = cfg["stft"], cfg["dataset"]
        stft = StftConfig(fs=st["fs"], window="hann", length=st["length"],
                          overlap=st["overlap"])
        model = make_miso1(model_config(cfg), ds["num_ch"], ds["num_spks"],
                           device=device)
        model.load_state_dict(self.sd["miso1"])
        o = cfg["optimizer"]
        opt = make_optimizer(OptimizerConfig(
            name=o["name"], lr=o["lr"], clipping=o["clipping"],
            max_norm=o["max_norm"]), model.parameters())
        self.state = create_train_state(model, opt)
        self.step = make_separate_wave_train_step(model, opt, stft, ds["ref_ch"])
        self.pool = traffic.batches(t, cfg, seed, device)
        self.batch = t["batch"]
        self.step_flops = 3 * self.batch * work_tfgridnet.forward_flops(cfg)
        # the first steps: the warm-up, and what the reference follows
        params = dict(model.named_parameters())
        self.losses, self.notes = [], {}
        for k in range(CHECK_STEPS):
            mix, wave_ref = self.pool[k]
            if half_batch:          # a planted fault: half the rows left out
                mix, wave_ref = mix[: len(mix) // 2], wave_ref[: len(wave_ref) // 2]
            _, m = self.step(self.state, mix, wave_ref)
            self.losses.append(float(m["loss"]))
            if k == 0:   # Adam's first moment after one step is (1 - b1) g
                b1 = opt.inner.param_groups[0]["betas"][0]
                self.grad1 = {n: opt.inner.state[p]["exp_avg"] / (1 - b1)
                              if p in opt.inner.state else torch.zeros_like(p)
                              for n, p in params.items()}
        self.k = CHECK_STEPS
        self.params3 = {n: p.detach().clone() for n, p in params.items()}
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()
            self.notes["memory_reserved_gib"] = torch.cuda.max_memory_reserved() / 2**30

    def reference(self, quant=None) -> dict:
        from benchmark.reference import training

        net = ref_net(self.cfg, self.device)
        net.load_state_dict(self.sd["miso1"])
        net.set_quant(quant)
        batches = [(m.to(self.device), r.to(self.device))
                   for m, r in self.pool[:CHECK_STEPS]]
        return training.train(net, batches, self.cfg, CHECK_STEPS,
                              self.cell["check"]["rows_per_block"])
