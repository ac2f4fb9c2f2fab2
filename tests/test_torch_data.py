"""PyTorch port, the data pipeline (misonet_tpu_torch/data) against the JAX
package's misonet_tpu/data: from the same seeds and files, the port's
``synth_mixture``, corpus discovery, extraction (per-utterance and the
native packer), ``ShardDataset``, ``Batcher`` and native bindings give the
same arrays, bit for bit (all of it is numpy on the host in both
packages); ``precompute_enhance_features`` gives JAX's MISO1 and MVDR
features from the same weights (moved by the bridge) within 1e-4 of
max-abs (float32; the decode's 60 conv layers and the MVDR's solve sum in
another order)."""

import pickle
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import dataclasses  # noqa: E402

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from misonet_tpu import config as jcfg  # noqa: E402
from misonet_tpu.data import dataset as jdataset  # noqa: E402
from misonet_tpu.data import extraction as jextraction  # noqa: E402
from misonet_tpu.data import native as jnative  # noqa: E402
from misonet_tpu.data import reverb as jreverb  # noqa: E402
from misonet_tpu.data import synthetic as jsynthetic  # noqa: E402
from misonet_tpu.data.precompute import (  # noqa: E402
    precompute_enhance_features as jprecompute,
)
from misonet_tpu.models import make_miso1 as jax_miso1  # noqa: E402
from misonet_tpu_torch import config as tcfg  # noqa: E402
from misonet_tpu_torch.data import dataset, extraction, native, reverb  # noqa: E402
from misonet_tpu_torch.data import synthetic  # noqa: E402
from misonet_tpu_torch.data.precompute import precompute_enhance_features  # noqa: E402
from misonet_tpu_torch.data.wavio import write_wav  # noqa: E402
from misonet_tpu_torch.models import make_miso1  # noqa: E402
from misonet_tpu_torch.utils.weights import load_jax_params  # noqa: E402


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """One intra-op thread: the suite runs several test processes at once,
    and a thread pool on every core in each slows them all down."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


CHUNK, LEAST = 2000, 1000


def _port(cfg):
    return getattr(tcfg, type(cfg).__name__)(**dataclasses.asdict(cfg))


def _same(a: dict, b: dict):
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), k


@pytest.mark.parametrize("voiced", [False, True])
def test_synth_mixture_matches_jax(voiced):
    for seed in (0, 7):
        _same(synthetic.synth_mixture(seed, 3000, 4, voiced=voiced),
              jsynthetic.synth_mixture(seed, 3000, 4, voiced=voiced))


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """An SMS-WSJ-layout corpus with early/tail/noise companions: 3
    utterances of 2,500-4,100 samples, 3 mics."""
    root = tmp_path_factory.mktemp("torch_data")
    dirs = {k: root / k for k in ("observation", "speech_source", "early",
                                  "tail", "noise")}
    for d in dirs.values():
        d.mkdir()
    for u, n in enumerate((2500, 4100, 3000)):
        d = synthetic.synth_mixture(u, n, 3)
        write_wav(dirs["observation"] / f"utt{u}.wav", d["mix"], 8000)
        write_wav(dirs["noise"] / f"utt{u}.wav", 0.1 * d["mix"], 8000)
        for s in range(2):
            write_wav(dirs["speech_source"] / f"utt{u}_{s}.wav", d["ref"][s],
                      8000)
            write_wav(dirs["early"] / f"utt{u}_{s}.wav", 0.5 * d["ref"][s],
                      8000)
            write_wav(dirs["tail"] / f"utt{u}_{s}.wav", 0.2 * d["ref"][s],
                      8000)
    return root, dirs


def _tuples(specs):
    """Extraction specs of either package as plain tuples."""
    return [dataclasses.astuple(s) for s in specs]


def _discover(mod, dirs):
    return mod.discover_smswsj(dirs["observation"], dirs["speech_source"], 2,
                               early_dir=dirs["early"], tail_dir=dirs["tail"],
                               noise_dir=dirs["noise"])


def _shards(out: Path) -> dict[str, dict]:
    shards = {}
    for p in sorted(out.glob("*.npz")):
        with np.load(p) as z:
            shards[p.name] = {k: z[k] for k in z.files}
    return shards


@pytest.mark.parametrize("use_native", [False, None])
def test_extraction_matches_jax(corpus, tmp_path, use_native):
    """The same specs, then the same shards (names, keys, arrays) from the
    per-utterance path (with a worker pool), and from the native wav
    decoder where native/libmisonet_native.so is built (``None``: both
    packages bind it when it is there, and fall back alike when not;
    tests/test_native.py builds it)."""
    _, dirs = corpus
    specs = _discover(extraction, dirs)
    jspecs = _discover(jextraction, dirs)
    assert _tuples(specs) == _tuples(jspecs)
    assert {k for s in specs for k, _ in s.companions} == {
        "early1", "early2", "tail1", "tail2", "noise"}
    n = extraction.extract_corpus(specs, tmp_path / "port", CHUNK, LEAST,
                                  workers=0 if use_native else 2,
                                  use_native=use_native)
    jn = jextraction.extract_corpus(jspecs, tmp_path / "jax", CHUNK, LEAST,
                                    use_native=use_native)
    assert n == jn == 2 + 4 + 3
    port, want = _shards(tmp_path / "port"), _shards(tmp_path / "jax")
    assert sorted(port) == sorted(want)
    for name in want:
        _same(port[name], want[name])


def test_reverb_discovery_matches_jax(tmp_path):
    for u in range(2):
        d = synthetic.synth_mixture(u, 1500, 2)
        write_wav(tmp_path / f"utt{u}.wav", d["mix"], 8000)
        write_wav(tmp_path / f"utt{u}_mix.wav", d["mix"], 8000)
        for s in range(2):
            write_wav(tmp_path / f"utt{u}_s{s}.wav", d["ref"][s], 8000)
            write_wav(tmp_path / f"utt{u}_ref{s + 1}.wav", d["ref"][s], 8000)
    (tmp_path / "list.lst").write_text("utt1\nutt0\n")
    for args in ((tmp_path / "list.lst", tmp_path), (tmp_path / "none.lst",
                                                     tmp_path)):
        got = _tuples(reverb.discover_reverb_2mix(*args))
        assert got == _tuples(jreverb.discover_reverb_2mix(*args)) and got
    got = _tuples(reverb.discover_rir_mixing(tmp_path))
    assert got == _tuples(jreverb.discover_rir_mixing(tmp_path)) and got


@pytest.fixture(scope="module")
def shard_dir(corpus, tmp_path_factory):
    """The corpus's shards."""
    _, dirs = corpus
    out = tmp_path_factory.mktemp("torch_shards")
    extraction.extract_corpus(_discover(extraction, dirs), out, CHUNK, LEAST,
                              use_native=False)
    return out


def _pickle_shard(path):
    """One chunk in the reference's pickle format."""
    rng = np.random.default_rng(3)
    with open(path, "wb") as f:
        pickle.dump({"mix": rng.standard_normal((CHUNK, 3)),
                     "ref1": rng.standard_normal(CHUNK),
                     "ref2": rng.standard_normal((CHUNK, 3))}, f)


@pytest.fixture(scope="module")
def mixed_dir(shard_dir, tmp_path_factory):
    """The shards plus one in the reference's pickle format."""
    out = tmp_path_factory.mktemp("torch_mixed")
    for p in shard_dir.glob("*.npz"):
        (out / p.name).write_bytes(p.read_bytes())
    _pickle_shard(out / "ref_format.pickle")
    return out


@pytest.mark.parametrize("kw,mixed", [
    ({}, True),
    ({"num_ch_utilize": 1, "extra_keys": ("early1", "noise")}, False),
    ({"host_index": 1, "host_count": 2}, True),
])
def test_dataset_and_batcher_match_jax(shard_dir, mixed_dir, kw, mixed):
    root = mixed_dir if mixed else shard_dir
    ds = dataset.ShardDataset(root, 2, **kw)
    jds = jdataset.ShardDataset(root, 2, **kw)
    assert ds.files == jds.files and len(ds) == len(jds) > 0
    for i in range(len(ds)):
        _same(ds[i], jds[i])
    for shuffle in (False, True):
        b = dataset.Batcher(ds, 2, shuffle=shuffle, seed=5)
        jb = jdataset.Batcher(jds, 2, shuffle=shuffle, seed=5)
        assert len(b) == len(jb)
        for _ in range(2):   # two epochs: the shuffle's rng moves on alike
            got, want = list(b), list(jb)
            assert len(got) == len(want) == len(b)
            for x, y in zip(got, want):
                _same(x, y)


def test_batcher_raises_what_its_producer_raised(shard_dir, tmp_path):
    """A batch that cannot be collated (an npz shard with a companion key,
    then a pickle shard without it) raises in the consumer; the JAX
    package's Batcher loses the producer's error and waits forever."""
    first = sorted(shard_dir.glob("*.npz"))[0]
    (tmp_path / "a.npz").write_bytes(first.read_bytes())
    _pickle_shard(tmp_path / "b.pickle")
    ds = dataset.ShardDataset(tmp_path, 2, extra_keys=("noise",))
    with pytest.raises(KeyError, match="noise"):
        list(dataset.Batcher(ds, 2, shuffle=False))


def test_native_bindings_match_jax(corpus):
    """The same library, or the same pure-Python fallback."""
    _, dirs = corpus
    assert native.available() == jnative.available()
    paths = sorted(str(p) for p in dirs["observation"].glob("*.wav"))
    for p in paths:
        assert native.wav_info(p) == jnative.wav_info(p)
        a, ra = native.read_wav_native(p)
        b, rb = jnative.read_wav_native(p)
        assert ra == rb and np.array_equal(a, b)
    for frames in (999, 1000, 2500, 4100):
        assert native.chunk_count(frames, CHUNK, LEAST) == \
            jnative.chunk_count(frames, CHUNK, LEAST)
    assert np.array_equal(native.pack_shards(paths, CHUNK, LEAST, 3),
                          jnative.pack_shards(paths, CHUNK, LEAST, 3))


STFT = jcfg.StftConfig(fs=8000, length=32, overlap=24)
SMALL = jcfg.ModelConfig(
    num_bottleneck=4, en_channels=(8, 8, 8, 16), de_channels=(16, 8, 8, 8),
    tcn_repeats=1, tcn_blocks=2, tcn_channels=16, compute_dtype="float32",
)
DS = jcfg.DatasetConfig(num_ch=3, num_ch_utilize=3, num_spks=2, ref_ch=0,
                        chunk_time=0.25, least_time=0.125)


def test_precompute_matches_jax(tmp_path):
    """Four shards, in JAX two batches of 2, in the port a batch of 3 and a
    tail of one: the same companions from the same MISO1 weights."""
    shards = jsynthetic.synth_shard_dir(tmp_path / "jax", num_utts=2,
                                        num_samples=2000, num_ch=3,
                                        chunk=CHUNK, least=LEAST)
    port_shards = tmp_path / "port"
    port_shards.mkdir()
    for p in sorted(shards.glob("*.npz")):
        (port_shards / p.name).write_bytes(p.read_bytes())
    jmodel = jax_miso1(SMALL)
    probe = jax.lax.complex(jnp.zeros((1, 3, 16, 17)),
                            jnp.zeros((1, 3, 16, 17)))
    params = jmodel.init(jax.random.key(3), probe)
    model = load_jax_params(
        make_miso1(_port(SMALL), num_mics=3, device="cpu"), params)
    n = precompute_enhance_features(model, port_shards, _port(STFT),
                                    _port(DS), batch_size=3)
    assert n == jprecompute(jmodel, params, shards, STFT, DS,
                            batch_size=2) == 4
    for p in sorted(shards.glob("*.feat.npz")):
        with np.load(p) as want, np.load(port_shards / p.name) as got:
            for k in ("miso1", "bf"):
                assert got[k].dtype == want[k].dtype == np.complex64
                scale = np.abs(want[k]).max()
                np.testing.assert_allclose(got[k] / scale, want[k] / scale,
                                           atol=1e-4, err_msg=f"{p.name} {k}")
