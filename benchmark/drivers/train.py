"""Training: the MISO1 step of ``make_separate_wave_train_step`` (in-graph
STFT, forward, uPIT loss, backward, the configuration's Adam and clipping)
in a closed loop over a seeded host pool of wave batches, each moved to the
card by the step as the trainer's batches are.

Set-up builds one train state and drives it through its first three steps
on three different batches, through the window's own call and feed; those
steps are the warm-up and the part the reference follows.  The window then
goes on with the same state.
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import program, traffic, work

CHECK_STEPS = 3


class Session:
    def __init__(self, cell: dict, cfg: dict, seed: int, device,
                 half_batch: bool = False):
        from misonet_tpu_torch.config import OptimizerConfig
        from misonet_tpu_torch.train import (create_train_state, make_optimizer,
                                             make_separate_wave_train_step)

        self.cell, self.cfg, self.seed, self.device = cell, cfg, seed, device
        t = cell["traffic"]
        self.sd = program.weights(cfg, seed, device)
        model = program.nets(cfg, self.sd, device)["miso1"]
        _, stft, ds = program.configs(cfg)
        o = cfg["optimizer"]
        opt = make_optimizer(OptimizerConfig(
            name=o["name"], lr=o["lr"], clipping=o["clipping"],
            max_norm=o["max_norm"]), model.parameters())
        self.state = create_train_state(model, opt)
        self.step = make_separate_wave_train_step(model, opt, stft, ds.ref_ch)
        self.pool = traffic.batches(t, cfg, seed, device)
        self.batch = t["batch"]
        per = work.nets(cfg)["miso1"]
        frames = work.frames(cfg)
        self.step_flops = 3 * self.batch * work.forward_flops(per, frames)
        # the first steps: the warm-up, and what the reference follows
        params = dict(model.named_parameters())
        self.losses, self.notes = [], {}
        for k in range(CHECK_STEPS):
            mix, ref = self.pool[k]
            if half_batch:          # a planted fault: half the rows left out
                mix, ref = mix[: len(mix) // 2], ref[: len(ref) // 2]
            _, m = self.step(self.state, mix, ref)
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

    def _steps(self, until=None, count=None):
        done = errors = 0
        while (count is None or done + errors < count) and (
                until is None or time.perf_counter() < until):
            mix, ref = self.pool[self.k % len(self.pool)]
            self.k += 1
            try:
                with torch.profiler.record_function("bench.step"):
                    _, m = self.step(self.state, mix, ref)
            except RuntimeError:
                errors += 1
                continue
            done += 1
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()
        return done, errors, m["loss"] if done else None

    def window(self, seconds: float) -> dict:
        t0 = time.perf_counter()
        done, errors, loss = self._steps(until=t0 + seconds)
        wall = time.perf_counter() - t0
        if loss is not None and not torch.isfinite(loss):
            errors += 1
        return {"seconds": wall, "attempted": done + errors, "failed": errors,
                "steps": done, "step_s": wall / max(done, 1),
                "flops": done * self.step_flops}

    def stretch(self, count: int) -> dict:
        done, errors, _ = self._steps(count=count)
        return {"count": done, "failed": errors, "steps": done,
                "passes": [{"net": "miso1", "items": self.batch, "backward": True}] * done}

    def check(self) -> list[tuple[str, float, float]]:
        """The loss of each of the first three steps, the first gradient as
        the optimizer got it (from Adam's state after one step) and the
        change of the parameters over the three steps, held against the
        plain reference's float32 steps from the same weights and batches.
        Gradient and change are compared by the worst leaf's gap of norms,
        against the larger of that leaf's and the median leaf's reference
        norm; leaves whose reference gradient is under a thousandth of the
        median leaf's are left out."""
        self.state = self.step = None
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        ref = self.reference()
        readings = compare(self, ref, self.notes)
        lim = self.cell["check"]["limits"]
        self.notes["readings"] = readings     # those without a limit too
        return [(k, readings[k], lim[k]) for k in lim]

    def reference(self, quant=None) -> dict:
        from benchmark.reference import training

        net = program.ref_net(self.cfg, "miso1", self.device)
        net.load_state_dict(self.sd["miso1"])
        net.set_quant(quant)
        batches = [(m.to(self.device), r.to(self.device))
                   for m, r in self.pool[:CHECK_STEPS]]
        return training.train(net, batches, self.cfg, CHECK_STEPS,
                              self.cell["check"]["rows_per_block"])


def compare(got, ref: dict, notes: dict | None = None) -> dict[str, float]:
    """The three readings of ``got`` (an object with ``losses``, ``grad1``,
    ``params3`` and the initial ``sd``) against ``ref``, leaf by name:

    ``loss``    the largest relative gap of the three steps' losses
    ``grad``    the median leaf's relative gap of first-gradient norms
    ``change``  the worst leaf's gap of parameter-change norms, against the
                larger of its own and the median leaf's reference norm
    ``frozen``  the leaves the reference moves that the program leaves
                exactly where they were (an exact count: the floor of
                ``change`` hides a small leaf left unmoved)

    Leaves whose reference gradient is under a thousandth of the median
    leaf's are left out of all three (they move by rounding alone).  The
    worst leaf's gradient gap, which uPIT's near-tied permutations and the
    ill-conditioned scalar leaves make swing from seed to seed at random
    weights, and the worst leaf's change gap against its own norm alone, go
    to ``notes``."""
    p0 = got.sd["miso1"]
    names = list(p0)
    loss = max(abs(a - b) / abs(b) for a, b in zip(got.losses, ref["loss"]))
    g_ref = np.array([float(ref["grad1"][n].norm()) for n in names])
    g_got = np.array([float(got.grad1[n].norm()) for n in names])
    keep = g_ref >= 1e-3 * np.median(g_ref)
    d_ref = np.array([float((ref["params"][n] - p0[n]).norm()) for n in names])
    d_got = np.array([float((got.params3[n] - p0[n]).norm()) for n in names])

    def gaps(a, b, floor=True):
        den = np.maximum(b, np.median(b[keep])) if floor else b
        return (np.abs(a - b) / np.where(keep, den, 1.0))[keep]

    out = {"loss": float(loss), "grad": float(np.median(gaps(g_got, g_ref, False))),
           "change": float(gaps(d_got, d_ref).max()),
           "frozen": float(np.sum(keep & (d_got == 0) & (d_ref > 0)))}
    if notes is not None:
        g = gaps(g_got, g_ref)
        kept = [n for n, k in zip(names, keep) if k]
        notes["grad_worst_leaf"] = max(zip(g.tolist(), kept))
        notes["change_worst_leaf_own"] = max(zip(gaps(d_got, d_ref, False).tolist(),
                                                 kept))
        notes["change_median_leaf"] = float(np.median(gaps(d_got, d_ref, False)))
        notes["left_out"] = [n for n, k in zip(names, keep) if not k]
        pm = np.asarray(ref["pit_margins"])
        notes["pit_margins_below"] = {f"{t:g}": int((pm < t).sum())
                                      for t in (1e-3, 1e-2)} | {"rows": pm.size}
    return out
