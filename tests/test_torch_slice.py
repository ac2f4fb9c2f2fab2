"""PyTorch port, the slice as a whole: the MISO1 forward and the MISO1-only
``CascadeEvaluator.process`` against the JAX package with the same
weights (moved by the bridge), and the port's independence from JAX.

Tolerance: float32 on both sides with the JAX plain path
(``flat_dense=False``); ~60 conv layers plus norms chain their rounding,
so the forward is held to 1e-4 normalized by max-abs, separated waves to
1e-4 of their max-abs and SI-SDR scores to 1e-3 dB."""

import pytest

torch = pytest.importorskip("torch")

import ast  # noqa: E402
import dataclasses  # noqa: E402
import pathlib  # noqa: E402
import pkgutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from misonet_tpu.config import DatasetConfig, ModelConfig, StftConfig  # noqa: E402
from misonet_tpu.inference.evaluate import CascadeEvaluator as JaxEvaluator  # noqa: E402
from misonet_tpu.models import make_miso1 as jax_miso1  # noqa: E402
import misonet_tpu_torch  # noqa: E402
from misonet_tpu_torch import config as tcfg  # noqa: E402
from misonet_tpu_torch.inference.evaluate import CascadeEvaluator  # noqa: E402
from misonet_tpu_torch.models import make_miso1 as port_miso1  # noqa: E402
from misonet_tpu_torch.models import make_miso3 as port_miso3  # noqa: E402
from misonet_tpu_torch.utils.weights import load_jax_params  # noqa: E402

ATOL = 1e-4


def make_miso1(cfg, **kw):
    """The port's MISO1 on the CPU, from the port's copy of ``cfg``."""
    return port_miso1(tcfg.ModelConfig(**dataclasses.asdict(cfg)),
                      device="cpu", **kw)


def _close(out, ref, atol=ATOL):
    out, ref = np.asarray(out), np.asarray(ref)
    assert out.shape == ref.shape, (out.shape, ref.shape)
    scale = np.abs(ref).max()
    np.testing.assert_allclose(out / scale, ref / scale, atol=atol)


def _random_params(model, x, seed):
    """JAX params of ``model`` with random values (shapes traced only):
    LeCun-scaled kernels, small random biases and affine terms."""
    shapes = jax.eval_shape(model.init, jax.random.key(0), x)
    rng = np.random.default_rng(seed)

    def draw(s):
        fan_in = int(np.prod(s.shape[:-1])) if len(s.shape) >= 2 else 0
        std = 1.0 / np.sqrt(fan_in) if fan_in > 1 else 0.1
        return jnp.asarray((std * rng.standard_normal(s.shape))
                           .astype(np.float32))

    return jax.tree.map(draw, shapes)


def _complex(rng, shape):
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(np.complex64)


def test_miso1_forward_matches_jax():
    cfg = ModelConfig(
        en_channels=(8, 8, 8, 8, 8, 16, 16),
        de_channels=(16, 16, 8, 8, 8, 8, 8),
        tcn_repeats=1, tcn_blocks=3, tcn_channels=16,
        compute_dtype="float32", flat_dense=False,
    )
    mix = _complex(np.random.default_rng(0), (1, 6, 8, 129))
    jmodel = jax_miso1(cfg)
    params = _random_params(jmodel, jnp.asarray(mix), 1)
    ref = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(mix)))

    model = load_jax_params(make_miso1(cfg), params)
    with torch.no_grad():
        out = model(torch.from_numpy(mix)).numpy()
    assert out.dtype == np.complex64
    _close(out.view(np.float32), ref.view(np.float32))


def _port(cfg):
    """The port's copy of a JAX package config."""
    return getattr(tcfg, type(cfg).__name__)(**dataclasses.asdict(cfg))


STFT = StftConfig(fs=8000, length=32, overlap=24)  # 17 bins
SMALL = ModelConfig(
    num_bottleneck=4, en_channels=(8, 8, 8, 16), de_channels=(16, 8, 8, 8),
    tcn_repeats=1, tcn_blocks=2, tcn_channels=16, compute_dtype="float32",
)
DS = DatasetConfig(num_ch=3, num_ch_utilize=3, num_spks=2, ref_ch=0,
                   chunk_time=0.25, least_time=0.125)  # 2000-sample chunks


@pytest.fixture(scope="module")
def evaluators():
    jmodel = jax_miso1(SMALL)
    probe = jax.lax.complex(jnp.zeros((1, 3, 16, 17)),
                            jnp.zeros((1, 3, 16, 17)))
    params = _random_params(jmodel, probe, 2)
    model = load_jax_params(make_miso1(SMALL, num_mics=3), params)
    return (JaxEvaluator(jmodel, params, STFT, DS, beamform_utterance=False),
            CascadeEvaluator(model, _port(STFT), _port(DS),
                             beamform_utterance=False))


@pytest.mark.parametrize("with_refs", [True, False])
def test_evaluator_matches_jax(evaluators, with_refs):
    jev, tev = evaluators
    rng = np.random.default_rng(7)
    n = 4500  # three chunks (the last one padded), bucket of four
    src = rng.standard_normal((2, n)).astype(np.float32)
    mix = (np.stack([src[0] + 0.5 * src[1], 0.7 * src[0] + src[1],
                     src[0] - src[1]], axis=1)
           + 0.05 * rng.standard_normal((n, 3))).astype(np.float32)
    refs = src if with_refs else None
    want = jev.process(mix, refs)
    got = tev.process(mix, refs)
    assert got.separated.shape == (2, n)
    assert np.isfinite(got.separated).all()
    _close(got.separated, want.separated)
    assert got.beamformed is None and got.enhanced is None
    assert set(got.si_sdr) == set(want.si_sdr)
    for k in want.si_sdr:
        assert abs(got.si_sdr[k] - want.si_sdr[k]) < 1e-3, (k, got.si_sdr)


def test_metrics_match_jax():
    from misonet_tpu import metrics as jmetrics
    from misonet_tpu_torch import metrics as tmetrics

    rng = np.random.default_rng(3)
    refs = rng.standard_normal((3, 2, 800)).astype(np.float32)
    est = (refs[:, ::-1] + 0.3 * rng.standard_normal(refs.shape)).astype(
        np.float32)
    want = np.asarray(jmetrics.si_sdr_pit(jnp.asarray(est), jnp.asarray(refs)))
    got = tmetrics.si_sdr_pit(torch.from_numpy(est), torch.from_numpy(refs))
    np.testing.assert_allclose(got.numpy(), want, atol=1e-3)
    single = tmetrics.si_sdr_pit(torch.from_numpy(est[0]),
                                 torch.from_numpy(refs[0]))
    np.testing.assert_allclose(single.item(), want[0], atol=1e-3)
    np.testing.assert_allclose(
        tmetrics.si_sdr(torch.from_numpy(est), torch.from_numpy(refs)).numpy(),
        np.asarray(jmetrics.si_sdr(jnp.asarray(est), jnp.asarray(refs))),
        atol=1e-3)
    assert tmetrics.numpy_si_sdr(est[0, 0], refs[0, 1]) == pytest.approx(
        jmetrics.numpy_si_sdr(est[0, 0], refs[0, 1]))


def test_evaluator_refuses_unported_modes():
    """Every evaluator mode is ported now (the default, utterance-mode
    beamforming, and the enhance nets construct), and so is the collective
    SCM (tests/test_torch_parallel.py).  A bf16 MISO1 (the JAX package's
    default compute dtype) builds and serves unchanged: float32 waves,
    finite scores."""
    from misonet_tpu_torch.beamforming.scm import chunked_scm

    model = make_miso1(SMALL, num_mics=3)
    stft, ds = _port(STFT), _port(DS)
    assert CascadeEvaluator(model, stft, ds).beamform_utterance
    assert CascadeEvaluator(model, stft, ds, enhance_model=model,
                            beamform_utterance=False).enhance_model is model
    blocks = torch.ones((2, 3, 4, 17), dtype=torch.complex64)
    assert torch.equal(chunked_scm(blocks),
                       torch.ones((17, 3, 3), dtype=torch.complex64))
    bf16 = dataclasses.replace(SMALL, compute_dtype="bfloat16")
    miso3 = port_miso3(_port(bf16), num_mics=3, device="cpu")
    rng = np.random.default_rng(8)
    src = rng.standard_normal((2, 4500)).astype(np.float32)
    mix = np.stack([src[0] + 0.5 * src[1], src[0] - src[1], src[1]], axis=1)
    ev = CascadeEvaluator(make_miso1(bf16, num_mics=3), stft, ds,
                          enhance_model=miso3)
    res = ev.process(mix, src)
    for wave in (res.separated, res.beamformed, res.enhanced):
        assert wave.shape == (2, 4500) and wave.dtype == np.float32
        assert np.isfinite(wave).all()
    assert all(np.isfinite(v) for v in res.si_sdr.values())


ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX_MODULES = ("jax", "jaxlib", "flax", "optax")


def _assert_imports_leave_out_jax(modules):
    """Import ``modules`` in a fresh interpreter at the repo root and check
    that no JAX module and no module of the JAX package (``misonet_tpu``
    or ``misonet_tpu.*``; ``misonet_tpu_torch`` is the port) got loaded."""
    code = "".join(f"import {m}\n" for m in ["sys", *modules]) + (
        "bad = sorted(m for m in sys.modules\n"
        f"             if m.split('.')[0] in {JAX_MODULES!r}\n"
        "             or m == 'misonet_tpu'\n"
        "             or m.startswith('misonet_tpu.'))\n"
        "assert not bad, bad\n"
        "print('ok')\n"
    )
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"


def test_port_imports_no_jax():
    """Every module of the port, found by walking the package."""
    modules = ["misonet_tpu_torch"] + sorted(
        m.name for m in pkgutil.walk_packages(misonet_tpu_torch.__path__,
                                              "misonet_tpu_torch."))
    assert {"misonet_tpu_torch.config", "misonet_tpu_torch.train.steps",
            "misonet_tpu_torch.ops.kernels.stencil_bwd",
            "misonet_tpu_torch.ops.kernels.hermitian_solve",
            "misonet_tpu_torch.beamforming.mvdr",
            "misonet_tpu_torch.beamforming.scm",
            "misonet_tpu_torch.inference.cascade",
            "misonet_tpu_torch.inference.css",
            "misonet_tpu_torch.data.wavio", "misonet_tpu_torch.cli",
            "misonet_tpu_torch.__main__", "misonet_tpu_torch.train.trainer",
            "misonet_tpu_torch.data.dataset",
            "misonet_tpu_torch.data.extraction",
            "misonet_tpu_torch.data.native",
            "misonet_tpu_torch.data.precompute",
            "misonet_tpu_torch.utils.checkpoint",
            "misonet_tpu_torch.utils.writer",
            "misonet_tpu_torch.utils.profiling",
            "misonet_tpu_torch.utils.port_torch",
            "misonet_tpu_torch.ops.kernels.dense_layer",
            "misonet_tpu_torch.parallel",
            "misonet_tpu_torch.parallel.distributed",
            "misonet_tpu_torch.parallel.mesh",
            "misonet_tpu_torch.parallel.tcn_sp",
            "misonet_tpu_torch.dryrun"} <= set(modules)
    _assert_imports_leave_out_jax(modules)


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py names no JAX module and nothing of the JAX package (its
    configs come through the port), and every module it imports, the
    phases' lazy imports included, loads without JAX."""
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    modules = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            modules.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            modules.add(node.module)
    tops = {m.split(".")[0] for m in modules}
    assert not tops & {*JAX_MODULES, "misonet_tpu"}, sorted(modules)
    assert "misonet_tpu_torch" in tops
    _assert_imports_leave_out_jax(["chip_smoke", *sorted(modules)])

