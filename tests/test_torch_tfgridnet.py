"""TF-GridNet as the port's MISO1 separator (``models/tfgridnet.py``) against
the benchmark's plain float32 reference (``benchmark/reference/tfgridnet.py``,
its LSTM written as its own recurrence) on seeded weights, at a tiny plan
(D = 8, H = 8, 2 blocks, 2 heads, F = 17, T = 20, 3 mics) on the CPU: the
forward in float32 and bfloat16, the gradients of one uPIT loss, one wave
train step against the reference's training step, the decode and streaming
CSS taking the net unchanged, the YAML route through ``make_miso1``, the
parameter count at the published widths, the spans and counters, the
module's two layout pieces (the norm written as the BLSTM's unfolded input,
the deconv as a matmul and an overlap-add) against ``F.unfold`` and
``F.conv_transpose1d``, and a bound on the copies one block makes.

Tolerances: float32 within 1e-5 of the reference's max-abs (the two differ
in the order of sums only); bfloat16 within 4 % in relative L2 (each stored
activation rounds to 8 bits of mantissa, 2^-9 relative; the tiny net chains
about 60 such roundings, through residuals that keep them from cancelling:
0.9-1.2 % measured over seven seeds).

Card only (marker ``cuda``): cuDNN's LSTM, as the port calls it
(sequence-major, its input's four taps tap-major), against the reference's
recurrence at the cell's widths (192 in, 192 units each way) on a short
sequence, forward and backward; run them on the card with
``python -m pytest --noconftest tests/test_torch_tfgridnet.py -m cuda``.
"""

import dataclasses
import json
import math

import pytest

torch = pytest.importorskip("torch")

import torch.nn.functional as F  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

from benchmark.reference import tfgridnet as ref  # noqa: E402
from benchmark.reference import training  # noqa: E402
from misonet_tpu_torch import cli  # noqa: E402
from misonet_tpu_torch.config import (DatasetConfig, OptimizerConfig,  # noqa: E402
                                      StftConfig, TFGridNetConfig, load_yaml)
from misonet_tpu_torch.inference.css import StreamingCSS  # noqa: E402
from misonet_tpu_torch.inference.separate import make_full_array_decode  # noqa: E402
from misonet_tpu_torch.losses import loss_upit  # noqa: E402
from misonet_tpu_torch.models import TFGridNet, make_miso1  # noqa: E402
from misonet_tpu_torch.models.tfgridnet import (ALONG_F, ALONG_T,  # noqa: E402
                                                GridNetBlock, _blstm, _deconv,
                                                _NormUnfold, init_parameters)
from misonet_tpu_torch.train import (create_train_state, make_optimizer,  # noqa: E402
                                     make_separate_wave_train_step)
from misonet_tpu_torch.utils import profiling  # noqa: E402

TINY = TFGridNetConfig(n_layers=2, emb_dim=8, lstm_hidden_units=8,
                       attn_n_head=2, n_fft=32, compute_dtype="float32")
MICS, SPKS, FREQS = 3, 2, 17
PLAN = {k: getattr(TINY, k) for k in (
    "n_layers", "emb_dim", "emb_ks", "emb_hs", "lstm_hidden_units",
    "attn_n_head", "attn_approx_qk_dim", "eps")}
STFT = StftConfig(length=32, overlap=24)
DS = DatasetConfig(chunk_time=0.125, least_time=0.0625, num_ch=MICS,
                   num_ch_utilize=MICS)
CFG = {"stft": {"fs": 8000, "length": 32, "overlap": 24},
       "dataset": {"fs": 8000, "ref_ch": 0},
       "optimizer": {"name": "adam", "lr": 1e-3, "clipping": True,
                     "max_norm": 5.0}}


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and a thread pool on every core in each slows them all down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair(seed=3, dtype="float32", **plan):
    """(port net, reference net, the state dict both hold); ``plan``
    changes TINY's widths."""
    cfg = dataclasses.replace(TINY, compute_dtype=dtype, **plan)
    net = ref.TFGridNet({k: getattr(cfg, k) for k in PLAN}, MICS, SPKS, FREQS)
    sd = ref.make_state_dict(net, seed, "cpu")
    net.load_state_dict(sd)
    port = make_miso1(cfg, MICS, SPKS, device="cpu")
    port.load_state_dict(sd)
    return port, net, sd


def _mix(seed=0, b=2, t=20):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(b, MICS, t, FREQS, dtype=torch.complex64, generator=g)


def _rel_l2(a, b):
    return float((a - b).abs().norm() / b.abs().norm())


@pytest.mark.parametrize("plan", [{}, {"emb_ks": 3, "emb_hs": 2}],
                         ids=["I4J1", "I3J2"])
def test_forward_matches_reference_float32(plan):
    """At ESPnet's kernel and stride, and at a stride that pads T and F
    before the unfolds and crops them before the attention."""
    port, net, _ = _pair(**plan)
    x = _mix()
    with torch.no_grad():
        got, want = port(x), net(x)
    assert got.shape == want.shape == (2, SPKS, 20, FREQS)
    assert got.dtype == torch.complex64
    assert float((got - want).abs().max()) <= 1e-5 * float(want.abs().max())


@pytest.mark.parametrize("seed", [3, 11])
def test_forward_bf16_within_bound(seed):
    port, net, _ = _pair(seed, "bfloat16")
    x = _mix(seed)
    with torch.no_grad():
        got, want = port(x), net(x)
    assert got.dtype == torch.complex64
    assert _rel_l2(got, want) <= 0.04


def _live(grads: dict) -> set:
    """The leaves whose gradient norm is at least a thousandth of the median
    leaf's, as the benchmark's check keeps them: the K projections' shifts
    have a gradient of 0 (a shift of every key adds one number to each
    query's scores, which the softmax takes away) and move by rounding."""
    norms = {n: float(g.norm()) for n, g in grads.items()}
    floor = 1e-3 * sorted(norms.values())[len(norms) // 2]
    live = {n for n, v in norms.items() if v >= floor}
    assert all(".attn_conv_K_" in n for n in set(grads) - live)
    return live


def test_gradients_match_reference_leaf_by_leaf():
    """One uPIT loss (the port's ``loss_upit``, the reference's
    ``upit_rows``) through each net: every live leaf's gradient within 1e-4
    of its own norm."""
    port, net, _ = _pair()
    x = _mix(1)
    r = _mix(2)[:, :SPKS]
    loss_upit(port(x), r).backward()
    training.upit_rows(net(x), r).mean().backward()
    want = {n: p.grad for n, p in net.named_parameters()}
    live = _live(want)
    assert len(live) >= len(want) - 2 * TINY.n_layers * TINY.attn_n_head
    for name, p in port.named_parameters():
        assert p.grad is not None and want[name] is not None, name
        if name in live:
            err = float((p.grad - want[name]).norm())
            assert err <= 1e-4 * float(want[name].norm()), name


def test_wave_train_step_matches_reference_training():
    """One ``make_separate_wave_train_step`` step (in-graph STFT, uPIT,
    backward, the clip at 5 and Adam) against ``reference.training.train``
    from the same weights and batch: the loss, and each leaf's change."""
    port, net, sd = _pair(5)
    g = torch.Generator().manual_seed(7)
    mix = torch.randn(2, 1000, MICS, generator=g) * 0.1
    wave_ref = torch.randn(2, SPKS, 1000, generator=g) * 0.1
    opt = make_optimizer(OptimizerConfig(clipping=True, max_norm=5.0),
                         port.parameters())
    state = create_train_state(port, opt)
    step = make_separate_wave_train_step(port, opt, STFT, 0)
    _, metrics = step(state, mix, wave_ref)
    want = training.train(net, [(mix, wave_ref)], CFG, 1, rows_per_block=1)
    assert math.isclose(float(metrics["loss"]), want["loss"][0], rel_tol=1e-5)
    live = _live(want["grad1"])
    for name, p in port.named_parameters():
        if name not in live:
            continue
        d_got = p.detach() - sd[name]
        d_want = want["params"][name] - sd[name]
        # Adam's first step is lr * g / (|g| + eps): a leaf's elements whose
        # gradient is near 0 may take either sign
        assert float((d_got - d_want).norm()) <= 0.02 * float(d_want.norm()) \
            + 1e-7, name


def test_decode_and_streaming_css_take_the_net():
    """The full-array decode and ``StreamingCSS`` run TF-GridNet as they
    run MISONet: the decode's reference-mic run is the net's own output."""
    port, _, _ = _pair()
    x = _mix(4, b=1, t=17)
    out = make_full_array_decode(port, MICS)(x)
    assert out.shape == (1, SPKS, MICS, 17, FREQS)
    with torch.no_grad():
        own = port(x)
    direct = out[:, :, 0]
    top = float(own.abs().max())
    for s in range(SPKS):   # the same speakers, in the decode's slot order
        assert min(float((direct[:, s] - own[:, k]).abs().max())
                   for k in range(SPKS)) <= 1e-5 * top
    css = StreamingCSS(port, STFT, DS)
    wave = torch.randn(DS.chunk_samples, MICS,
                       generator=torch.Generator().manual_seed(8)).numpy()
    state, bf, m1 = css.process_block(css.init_state(SPKS), wave)
    assert bf.shape == m1.shape == (SPKS, DS.chunk_samples)
    assert float(state.frames) > 0


def test_yaml_routes_to_tfgridnet(tmp_path):
    cfg = load_yaml("configs/tfgridnet_smswsj.yml")
    assert cfg.miso1 == TFGridNetConfig()
    assert cfg.optimizer.clipping and cfg.optimizer.max_norm == 5.0
    with open("configs/tfgridnet_smswsj.yml") as f:
        text = f.read()
    small = (text.replace("length: 256", "length: 32")
             .replace("overlap: 192", "overlap: 24")
             .replace("emb_dim: 48", "emb_dim: 8")
             .replace("lstm_hidden_units: 192", "lstm_hidden_units: 8"))
    path = tmp_path / "tiny.yml"
    path.write_text(small)
    tiny = load_yaml(path)
    assert tiny.miso1.n_fft == 32 and tiny.miso1.emb_dim == 8
    model = cli._model(tiny, "MISO1", "cpu")
    assert isinstance(model, TFGridNet) and model.cfg is tiny.miso1
    assert model(_mix(t=12)[:, :, :, :17].repeat(1, 2, 1, 1)).shape == (
        2, 2, 12, 17)
    path.write_text(small.replace("network: TFGridNet",
                                  "network: TFGridNet\n  n_fft: 64"))
    with pytest.raises(ValueError, match="n_fft"):
        load_yaml(path)


def test_parameter_count_at_published_widths():
    """ESPnet's TFGridNet defaults at 6 mics, 2 speakers, F = 129."""
    with torch.device("meta"):
        model = TFGridNet(TFGridNetConfig(), 6, 2)
    assert sum(p.numel() for p in model.parameters()) == 8_244_130
    with open("benchmark/configs/tfgridnet/tfgridnet_smswsj_bf16.json") as f:
        assert json.load(f)["params_per_net"]["miso1"] == 8_244_130


def _relayout_bytes(b, t, f, plan=PLAN, freqs=FREQS, elem=4):
    """The bytes one forward's layout work writes at [B, T, F] in float32,
    from the shapes: per module the gather of the BLSTM's input [L', N, I*D]
    and the overlap-add's float32 accumulator [B, T, F, D] plus its taps
    (as many elements as the gather); per block the attention's Q, K, V
    stacked by heads and the heads' output relaid into channels."""
    d, i = plan["emb_dim"], plan["emb_ks"]
    heads = plan["attn_n_head"]
    e = math.ceil(plan["attn_approx_qk_dim"] / freqs)
    x = b * t * f * d
    total = 0
    for steps, n in ((f, b * t), (t, b * f)):          # intra, then inter
        u = (steps - i + 1) * n * i * d
        total += u * elem + (x + u) * 4
    total += (2 * heads * b * t * f * e + 2 * x) * elem
    return plan["n_layers"] * total


def test_spans_and_rnn_steps_counter():
    """Under a profiler: each block's three spans, a ``tfgridnet.rnn`` span
    a BLSTM call and a ``tfgridnet.rnn_bwd`` span its backward, the counter
    adding each call's sequence length: n_layers x (F' + T'), and the
    relayout counter at its value from the shapes."""
    port, _, _ = _pair()
    x = _mix(t=20)
    profiling.reset()
    with profile(activities=[ProfilerActivity.CPU]):
        port(x).abs().sum().backward()
    rec = profiling.records()
    names = [s.name for s in rec["spans"]]
    profiling.reset()
    for name, n in (("tfgridnet.intra", 2), ("tfgridnet.inter", 2),
                    ("tfgridnet.attn", 2), ("tfgridnet.rnn", 4),
                    ("tfgridnet.rnn_bwd", 4)):
        assert names.count(name) == n, name
    assert rec["counts"]["tfgridnet.rnn_steps"] == 2 * ((17 - 3) + (20 - 3))
    assert rec["counts"]["tfgridnet.relayout_bytes"] == _relayout_bytes(2, 20, 17)
    assert all(s.end_ns >= s.start_ns > 0 for s in rec["spans"])


def _sequences(x, perm):
    """[B, T, F, C] -> [N, C, S]: the sequences along the axis ``perm``
    puts first, as the reference lays them out."""
    seq = x.permute(perm)                                  # [S, N1, N2, C]
    return seq.flatten(1, 2).permute(1, 2, 0)


@pytest.mark.parametrize("stride,t0,f0", [(1, 9, 7), (2, 10, 8), (2, 9, 7)],
                         ids=["J1", "J2", "J2-padded"])
@pytest.mark.parametrize("perm", [ALONG_F, ALONG_T], ids=["along_F", "along_T"])
def test_unfold_and_deconv_match_unfold_and_conv_transpose(stride, t0, f0, perm):
    """The module's two layout pieces at small widths in float32, forward
    and every gradient within 1e-6 of the reference's max-abs: the norm's
    last op written as the BLSTM's unfolded input (``_NormUnfold``) against
    ``xhat * gamma + beta`` through ``F.unfold``, and the deconv as one
    matmul and an overlap-add (``_deconv``) against ``h +
    F.conv_transpose1d``; T and F padded as the block pads them."""
    d, taps, hid = 3, 4, 2
    g = torch.Generator().manual_seed(stride * 100 + t0)
    t = math.ceil((t0 - taps) / stride) * stride + taps
    f = math.ceil((f0 - taps) / stride) * stride + taps
    xhat = F.pad(torch.randn(2, t0, f0, d, generator=g),
                 (0, 0, 0, f - f0, 0, t - t0)).requires_grad_()
    gamma, beta = (torch.randn(d, generator=g).requires_grad_() for _ in "gb")
    u = _NormUnfold.apply(xhat, gamma, beta, perm, taps, stride, torch.float32)
    seq = _sequences(xhat * gamma + beta, perm)            # [N, D, S]
    want = F.unfold(seq[..., None], (taps, 1), stride=(stride, 1))
    n, steps = seq.shape[0], want.shape[-1]
    # F.unfold's columns are channel-major (c * I + k); the BLSTM's tap-major
    want = want.view(n, d, taps, steps).permute(3, 0, 2, 1).reshape(steps, n, -1)
    assert u.shape == want.shape
    cot = torch.randn(want.shape, generator=g)
    leaves = (xhat, gamma, beta)
    got_g = torch.autograd.grad((u * cot).sum(), leaves)
    want_g = torch.autograd.grad((want * cot).sum(), leaves)
    for a, b in zip((u, *got_g), (want, *want_g)):
        assert float((a - b).detach().abs().max()) <= 1e-6 * float(b.abs().max())

    linear = torch.nn.ConvTranspose1d(2 * hid, d, taps, stride=stride)
    h = torch.randn(2, t, f, d, generator=g, requires_grad=True)
    y = torch.randn(steps, *(h.shape[p] for p in perm[1:3]), 2 * hid,
                    generator=g, requires_grad=True)
    got = _deconv(linear, y, h, perm, stride)
    conv = linear(y.flatten(1, 2).permute(1, 2, 0))         # [N, D, S]
    want = h + conv.permute(2, 0, 1).view(
        [h.shape[p] for p in perm]).permute([perm.index(k) for k in range(4)])
    cot = torch.randn(h.shape, generator=g)
    leaves = (y, h, linear.weight, linear.bias)
    got_g = torch.autograd.grad((got * cot).sum(), leaves)
    want_g = torch.autograd.grad((want * cot).sum(), leaves)
    for a, b in zip((got, *got_g), (want, *want_g)):
        assert float((a - b).detach().abs().max()) <= 1e-6 * float(b.abs().max())


# aten::copy_ elements written by one GridNetBlock's forward and backward at
# TINY's widths, B = 2, T = 20, F = 17, counted by ``_copied_elements``: the
# parent commit's block, which took [B, D, T, F] and laid it out for each
# module and for cuDNN's calls, wrote 231,695 (42.6 x numel(x)).
PARENT_COPIED = 231_695
# copies that only the CPU's kernels make, left out on both sides: its
# matmul and 1x1 conv write the bias into the output before they accumulate
# (the card's GEMM adds it in its epilogue), and its LSTM's backward makes
# each direction's slice of the gradient contiguous (cuDNN reads it whole)
CPU_ONLY = ("aten::addmm", "aten::_slow_conv2d_forward",
            "aten::mkldnn_rnn_layer_backward")


def _copied_elements(run) -> int:
    """Elements written by ``aten::copy_`` while ``run()`` runs, forward and
    backward, outside the ops in ``CPU_ONLY``."""
    with profile(activities=[ProfilerActivity.CPU], record_shapes=True) as prof:
        run()
    total = 0
    for ev in prof.events():
        if ev.name != "aten::copy_":
            continue
        up, inside = ev.cpu_parent, False
        while up is not None:
            inside |= up.name in CPU_ONLY
            up = up.cpu_parent
        if not inside:
            total += math.prod(ev.input_shapes[0])
    return total


def test_block_copies_at_most_a_third_of_parent():
    """One GridNetBlock's forward and backward at TINY's widths with B = 2
    copies at most a third of what the parent commit's block copied
    (``PARENT_COPIED``); this tree's block writes 62,343 (11.5 x numel(x))."""
    blk = GridNetBlock(TINY, FREQS)
    init_parameters(blk, torch.Generator().manual_seed(0))
    g = torch.Generator().manual_seed(1)
    x = torch.randn(2, 20, FREQS, TINY.emb_dim, generator=g, requires_grad=True)
    cot = torch.randn(x.shape, generator=g)
    copied = _copied_elements(lambda: (blk(x) * cot).sum().backward())
    assert x.grad is not None
    assert copied <= PARENT_COPIED / 3, copied


# --- on the card -----------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _lstm_pair(device, seed=0):
    """The port's ``nn.LSTM`` and the reference's ``BLSTM`` at the cell's
    widths (192 inputs, 192 units), holding the same seeded weights."""
    lstm = torch.nn.LSTM(192, 192, 1, bidirectional=True)
    rec = ref.BLSTM(192, 192)
    sd = ref.make_state_dict(rec, seed, "cpu")
    rec.load_state_dict(sd)
    lstm.load_state_dict(sd)
    return lstm.to(device), rec.to(device)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(torch.float32, 1e-5),
                                       (torch.bfloat16, 0.03)])
def test_cudnn_lstm_matches_recurrence(cuda, dtype, tol):
    """Forward, the input's gradient and each weight's gradient of the
    port's BLSTM call (cuDNN, sequence-major, the input's 4 taps of 48
    channels tap-major as the modules give it) against the reference's
    recurrence in float32 (batch-first, channel-major), on 64 sequences of
    24 steps; bfloat16 within 3 % in relative L2 (its inputs, weights and
    states round at 2^-9; 24 steps)."""
    lstm, rec = _lstm_pair(cuda)
    g = torch.Generator(device=cuda).manual_seed(1)
    x = torch.randn(64, 24, 192, device=cuda, generator=g)
    xa = x.to(dtype).detach().requires_grad_()
    xb = x.detach().clone().requires_grad_()
    seq = xa.view(64, 24, 48, 4).transpose(2, 3).reshape(64, 24, 192)
    got = _blstm(lstm, seq.transpose(0, 1).contiguous(), True, 4)
    assert "CudnnRnn" in got.grad_fn.name()
    got = got.transpose(0, 1)
    want = rec(xb)
    w = torch.randn(want.shape, device=cuda, generator=g)
    (got.float() * w).sum().backward()
    (want * w).sum().backward()
    assert _rel_l2(got.float(), want) <= tol
    assert _rel_l2(xa.grad.float(), xb.grad) <= tol
    params = dict(rec.named_parameters())
    for name, p in lstm.named_parameters():
        assert _rel_l2(p.grad, params[name].grad) <= tol, name


@pytest.mark.cuda
def test_tfgridnet_on_card_matches_reference(cuda):
    """The port's bfloat16 TF-GridNet on the card at the cell's widths on a
    short input (T = 24), against the float32 reference: within 4 % in
    relative L2, as on the CPU."""
    cfg = TFGridNetConfig()
    net = ref.TFGridNet({k: getattr(cfg, k) for k in PLAN}, 6, 2, 129).to(cuda)
    sd = ref.make_state_dict(net, 5, cuda)
    net.load_state_dict(sd)
    port = make_miso1(cfg, 6, 2, device=cuda)
    port.load_state_dict(sd)
    g = torch.Generator(device=cuda).manual_seed(2)
    x = torch.randn(2, 6, 24, 129, dtype=torch.complex64, device=cuda,
                    generator=g)
    with torch.no_grad():
        assert _rel_l2(port(x), net(x)) <= 0.04
