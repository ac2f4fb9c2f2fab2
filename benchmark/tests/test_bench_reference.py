"""The plain reference against the measured program run in float32 on the
CPU (its plain path), at the tiny plan: the same weights give the same
waves, losses and gradients, so the reference computes the program's
function and a bf16 run's readings measure precision alone."""

import copy

import numpy as np
import torch

from benchmark import program, traffic
from benchmark.drivers import train as train_driver
from benchmark.reference import serving, training
from benchmark.tests import tiny

F32 = dict(tiny.CONFIG, precision="float32")
FULL = {"num_bottleneck": 7, "en_channels": [24, 32, 32, 32, 32, 64, 128],
        "de_channels": [128, 64, 32, 32, 32, 32, 24], "norm_type": "IN",
        "tcn_repeats": 2, "tcn_blocks": 7, "tcn_channels": 128,
        "flat_dense": "auto"}


def _pair(cfg, seed):
    sd = program.weights(cfg, seed, "cpu")
    prog = program.nets(cfg, sd, "cpu")
    ref = {}
    for name in cfg["nets"]:
        ref[name] = program.ref_net(cfg, name, "cpu")
        ref[name].load_state_dict(sd[name])
    return sd, prog, ref


def test_state_dicts_match_the_programs_at_full_width():
    cfg = dict(tiny.CONFIG, model=FULL,
               stft={"fs": 8000, "length": 256, "overlap": 192})
    sd = program.weights(cfg, 1, "cpu")
    prog = program.nets(cfg, sd, "cpu")
    for name in cfg["nets"]:
        assert list(prog[name].state_dict()) == list(sd[name])
    assert sum(v.numel() for v in sd["miso1"].values()) == 2587384


def test_cascade_matches_the_program_in_float32():
    from misonet_tpu_torch.inference.evaluate import CascadeEvaluator

    _, prog, ref = _pair(F32, 4)
    _, stft, ds = program.configs(F32)
    ev = CascadeEvaluator(prog["miso1"], stft, ds, enhance_model=prog["miso3"],
                          beamform_utterance=True)
    mix = traffic.mixture(traffic.generator(9, "pool", "cpu"), 1300, 6, 8000)[0]
    mix = mix.numpy()                                               # 3 chunks
    got = ev.process(mix)
    want = serving.cascade(ref["miso1"], ref["miso3"], mix, F32, "cpu")[0][0]
    for key in ("separated", "beamformed", "enhanced"):
        assert program.rel_err(getattr(got, key), want[key]) < 1e-4, key


def test_css_matches_the_program_in_float32():
    from misonet_tpu_torch.inference.css import StreamingCSS

    _, prog, ref = _pair(F32, 5)
    _, stft, ds = program.configs(F32)
    css = StreamingCSS(prog["miso1"], stft, ds)
    scene = traffic.scene({"scene_s": 0.75}, F32, 6, "cpu")
    state = css.init_state(2)
    want = serving.css(ref["miso1"], scene, 3, F32, "cpu")[0][0]
    for k in range(3):
        state, bf, m1 = css.process_block(state, scene[k * 2000:(k + 1) * 2000])
        assert program.rel_err(m1, want[k]["miso1"]) < 1e-4
        assert program.rel_err(bf, want[k]["beamformed"]) < 1e-4


def test_train_steps_match_the_program_in_float32():
    cell = copy.deepcopy(tiny.CELLS["tiny.train"])
    s = train_driver.Session(cell, F32, 8, "cpu")
    ref = s.reference()
    r = train_driver.compare(s, ref)
    # Adam moves near-zero gradient entries by ~lr whatever their size, so
    # rounding alone moves the change by some 1e-3
    assert r["loss"] < 1e-4 and r["grad"] < 1e-3 and r["change"] < 1e-2, r


def test_row_blocks_do_not_change_the_step():
    cfg = dict(tiny.CONFIG, nets=["miso1"])
    sd = program.weights(cfg, 2, "cpu")
    batches = traffic.batches({"pool": 1, "batch": 4, "chunk_s": 0.25}, cfg, 2,
                              "cpu")
    outs = []
    for rows in (1, 4):
        net = program.ref_net(cfg, "miso1", "cpu")
        net.load_state_dict(sd["miso1"])
        outs.append(training.train(net, batches, cfg, 1, rows))
    assert np.isclose(outs[0]["loss"][0], outs[1]["loss"][0], rtol=1e-5)
    for n, g in outs[0]["grad1"].items():
        torch.testing.assert_close(g, outs[1]["grad1"][n], rtol=1e-4, atol=1e-6)


def test_ties_give_both_orders():
    tie = torch.tensor([[1.0, 1.0005], [1.0005, 1.0]])   # identity by 2.5e-4
    clear = torch.tensor([[1.0, 2.0], [2.0, 1.0]])

    def run(dec):
        return (tuple(dec.choose("a", tie).tolist()),
                tuple(dec.choose("b", clear).tolist()))

    outs, margins = serving.variants(run)
    assert outs == [((0, 1), (0, 1)), ((1, 0), (0, 1))]
    assert min(margins) < serving.TIE < max(margins)
