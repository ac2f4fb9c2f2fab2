"""The stall watchdog of the test processes (tests/stall_watchdog.py).

Importing this file starts the watchdog in the process that imports it, and
turns off JAX's asynchronous CPU dispatch there (the one stall caught so
far, stall_watchdog.py says which); every pytest-xdist worker imports every
test file at collection, before any test starts the JAX backend, so every
worker of a whole run is armed; a run that selects files or tests without
this one runs unwatched and dispatches asynchronously.  Its tests run
pytest subprocesses over generated test files at a 3 s limit.
"""

import os
import subprocess
import sys
from pathlib import Path

import stall_watchdog

SYNCHRONOUS = stall_watchdog.synchronous_cpu_dispatch()
stall_watchdog.start(stall_watchdog.STALL_LIMIT_S)

TESTS = Path(__file__).resolve().parent
HEAD = ("import time\nimport stall_watchdog\n"
        "stall_watchdog.start({limit}, poll=0.1)\n")


def _pytest(tmp_path, files, *args):
    for name, body in files.items():
        (tmp_path / name).write_text(body)
    # the child is a pytest run of its own: none of this run's PYTEST_*
    env = {k: v for k, v in os.environ.items() if not k.startswith("PYTEST_")}
    env.update(TMPDIR=str(tmp_path), PYTHONPATH=os.pathsep.join(
        p for p in (str(TESTS), os.environ.get("PYTHONPATH")) if p))
    return subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-p", "no:cacheprovider",
         "-p", "no:randomly", "-p", "xdist", *args, *files],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=240)


def test_watchdog_names_and_ends_a_stuck_test(tmp_path):
    out = _pytest(tmp_path, {"test_hang.py": HEAD.format(limit=3) + (
        "def test_quick():\n    pass\n"
        "def test_stuck():\n    time.sleep(200)\n")},
        "-n", "1", "--max-worker-restart", "0")
    assert out.returncode != 0
    assert "crashed while running 'test_hang.py::test_stuck'" in out.stdout
    assert "1 passed" in out.stdout
    dumps = [p.read_text() for p in tmp_path.glob("misonet-stall-*.txt")]
    assert any("in test_stuck" in d for d in dumps), dumps


def test_watchdog_spares_idle_workers_and_short_tests(tmp_path):
    """One worker idles past the limit while the other runs four tests of
    a third of it each (more than the limit together): nothing is killed."""
    out = _pytest(tmp_path, {
        "test_idle.py": HEAD.format(limit=3) + "def test_a():\n    pass\n",
        "test_busy.py": HEAD.format(limit=3) + (
            "import pytest\n"
            "@pytest.mark.parametrize('i', range(4))\n"
            "def test_b(i):\n    time.sleep(1.0)\n")},
        "-n", "2", "--dist", "loadfile")
    assert out.returncode == 0, out.stdout + out.stderr
    assert "5 passed" in out.stdout
    assert "crashed" not in out.stdout
    assert not list(tmp_path.glob("misonet-stall-*"))  # nothing to keep


def test_current_test_drops_the_phase():
    assert stall_watchdog.current_test(
        "tests/a.py::test_b[x (y)] (call)") == "tests/a.py::test_b[x (y)]"
    assert stall_watchdog.current_test(None) is None


def test_cpu_dispatch_is_synchronous():
    """JAX's CPU client of this process runs computations inline: the
    option was set before the backend started (at collection), and a
    computation's result is ready when the call returns."""
    import jax
    import jax.numpy as jnp

    assert SYNCHRONOUS
    assert jax.config.read("jax_cpu_enable_async_dispatch") is False
    y = jnp.arange(4.0) * 2
    assert y.is_ready() and float(y.sum()) == 12.0
