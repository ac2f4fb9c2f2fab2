"""Streaming CSS: one closed-loop stream of consecutive 4 s blocks of a long
scene through ``StreamingCSS.process_block`` (MISO1 decode of the block,
running SCMs, one MVDR), the served path of ``Test -t CSS``.  The running
state is reset at each pass's start over the scene.  A block's latency is
the host clock from the call to the returned waves.
"""

from __future__ import annotations

import time
import traceback

import torch

import numpy as np

from benchmark import program, traffic, work
from benchmark.drivers import cascade


class Session:
    def __init__(self, cell: dict, cfg: dict, seed: int, device,
                 quant_int8: bool = False):
        from misonet_tpu_torch.inference.css import StreamingCSS

        self.cell, self.cfg, self.seed, self.device = cell, cfg, seed, device
        t = cell["traffic"]
        self.forget = t["forget"]
        self.sd = program.weights(cfg, seed, device)
        nets = program.nets(cfg, self.sd, device, quant_int8)
        _, stft, ds = program.configs(cfg)
        self.css = StreamingCSS(nets["miso1"], stft, ds, forget=self.forget)
        self.spks, self.chunk, self.fs = ds.num_spks, ds.chunk_samples, ds.fs
        self.scene = traffic.scene(t, cfg, seed, device)
        self.blocks = [self.scene[k * self.chunk:(k + 1) * self.chunk]
                       for k in range(self.scene.shape[0] // self.chunk)]
        per = work.nets(cfg)["miso1"]
        frames = work.frames(cfg)
        self.block_flops = ds.num_ch * work.forward_flops(per, frames)
        self.rows = ds.num_ch
        self.kept: list = []        # the first pass's blocks
        self.passes = 0
        self.pos = 0
        self.state = self.css.init_state(self.spks)
        warm = self.css.init_state(self.spks)
        for block in self.blocks[:2]:   # warm-up: the first block and a later one
            warm, _, _ = self.css.process_block(warm, block)
        if torch.device(device).type == "cuda":
            torch.cuda.synchronize()

    def _next(self, records: list, errors: list) -> None:
        if self.pos == 0:
            self.state = self.css.init_state(self.spks)
        t0 = time.perf_counter()
        try:
            with torch.profiler.record_function("bench.request"):
                self.state, bf, m1 = self.css.process_block(
                    self.state, self.blocks[self.pos])
        except Exception:  # a failed block counts, the run goes on
            errors.append(traceback.format_exc(limit=-4))
            bf = m1 = None
        t1 = time.perf_counter()
        if bf is not None:
            records.append((t0, t1))
            if self.passes == 0 and len(self.kept) == self.pos:
                self.kept.append({"miso1": m1, "beamformed": bf})
        self.pos += 1
        if self.pos == len(self.blocks):
            self.pos, self.passes = 0, self.passes + 1

    def window(self, seconds: float) -> dict:
        records, errors = [], []
        end = time.perf_counter() + seconds
        while time.perf_counter() < end:
            self._next(records, errors)
        done = [r for r in records if r[1] <= end]
        return {"seconds": seconds, "attempted": len(records) + len(errors),
                "failed": len(errors), "errors": errors[:3],
                "latencies_ms": [(b - a) * 1e3 for a, b in done],
                "slices": cascade.slices(done, end - seconds, seconds),
                "audio_s": len(done) * self.chunk / self.fs,
                "flops": len(done) * self.block_flops, "requests": len(done)}

    def stretch(self, count: int) -> dict:
        records, errors = [], []
        for _ in range(count):
            self._next(records, errors)
        n = len(records)
        return {"count": n, "failed": len(errors), "blocks": n,
                "passes": [{"net": "miso1", "items": self.rows, "backward": False}] * n}

    def check(self) -> list[tuple[str, float, float]]:
        """Every block of the first pass over the scene, from its start,
        held against the plain reference's stream: the largest relative L2
        error of the MISO1 and the beamformed waves."""
        from benchmark.reference import serving

        self.css = self.state = None
        if torch.device(self.device).type == "cuda":
            torch.cuda.empty_cache()
        net = program.ref_net(self.cfg, "miso1", self.device)
        net.load_state_dict(self.sd["miso1"])
        outs, margins = serving.css(net.eval(), self.scene, len(self.kept),
                                    self.cfg, self.device, self.forget)
        lim = self.cell["check"]["limits"]
        # the stream as a whole against its nearest variant
        got = {k: np.concatenate([b[k] for b in self.kept], -1) for k in lim}
        refs = [{k: np.concatenate([b[k] for b in v], -1) for k in lim}
                for v in outs]
        j, _ = cascade.nearest(got, refs, lim)
        # each block's own error in the nearest variant
        worst = {k: max(program.rel_err(p[k], r[k]) for p, r in zip(self.kept, outs[j]))
                 for k in lim}
        self.notes = {"blocks": len(self.kept), "tie_variants": len(outs) - 1,
                      "margins_below": cascade.margins_below(margins)}
        return [(k, v, lim[k]) for k, v in worst.items()]
