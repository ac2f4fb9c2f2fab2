"""A per-test stall watchdog for the test processes.

tests/test_torch_stall_watchdog.py calls ``start(STALL_LIMIT_S)`` when it is
imported, and every pytest-xdist worker imports every test file, so every
worker runs one.  A daemon thread polls ``PYTEST_CURRENT_TEST`` every
``poll`` seconds:

- when a new test starts, it arms ``faulthandler.dump_traceback_later(limit,
  exit=True)``: a test still running ``limit`` seconds later makes its
  process write every thread's stack to ``<tempdir>/misonet-stall-<pid>.txt``
  and exit, and pytest-xdist reports that test by name as failed ("worker
  'gwN' crashed while running '<test>'") and goes on with a new worker;
- when no test is running, it cancels the timer, so a worker that waits
  between tests or for work is never killed.

A stall outside every test (the xdist controller, collection) is not seen.

``synchronous_cpu_dispatch()`` is meant to remove the one stall caught so
far (unproven: the stall is intermittent, and if it comes back this
mitigation goes, ROADMAP section 3 item 1): a whole
run stopped in tests/test_stencil_bwd.py::test_final_bwd_matches_twin, where
an interpret-mode Pallas call's ``store`` callback iterated a ``jax.Array``
(dispatching slices from the callback's thread) while the main thread
dispatched the next eager primitive of ``jax.grad``, and neither returned
(JAX 0.9.0; the stacks in the dump).  With CPU computations run inline the
main thread waits while a computation and its callbacks run.
The limit sits 2.7 times above the slowest test of a whole run (177 s
under ``-n 6``, setup included) and well inside the run's own limit
(1,470 s).  A process that ends normally removes its dump file if it is
empty.
"""

from __future__ import annotations

import atexit
import faulthandler
import os
import tempfile
import threading
import time

STALL_LIMIT_S = 480.0
POLL_S = 2.0
THREAD_NAME = "misonet-stall-watchdog"


def current_test(value: str | None) -> str | None:
    """The test id of a PYTEST_CURRENT_TEST value ("<id> (call)")."""
    return value.rsplit(" (", 1)[0] if value else None


def _watch(limit: float, poll: float, dump) -> None:
    running = None
    while True:
        test = current_test(os.environ.get("PYTEST_CURRENT_TEST"))
        if test != running:
            running = test
            if test is None:
                faulthandler.cancel_dump_traceback_later()
            else:
                faulthandler.dump_traceback_later(limit, exit=True,
                                                  file=dump)
        time.sleep(poll)


def _drop_if_empty(dump) -> None:
    dump.close()
    if os.path.getsize(dump.name) == 0:
        os.remove(dump.name)


def synchronous_cpu_dispatch() -> bool:
    """Turn off JAX's asynchronous CPU dispatch (``jax_cpu_enable_async_
    dispatch``), which JAX reads when its CPU backend starts; False if the
    backend had already started (then it stays asynchronous), or if this
    JAX lacks the option or the private ``xla_bridge._backends`` that says
    whether it started (then test_cpu_dispatch_is_synchronous fails, and
    collection goes on)."""
    import jax

    try:
        jax.config.update("jax_cpu_enable_async_dispatch", False)
        from jax._src import xla_bridge
    except (AttributeError, ImportError):
        return False
    backends = getattr(xla_bridge, "_backends", None)
    return backends is not None and not backends


def start(limit: float = STALL_LIMIT_S, poll: float = POLL_S) -> bool:
    """Start this process's watchdog; False if one already runs."""
    if any(t.name == THREAD_NAME for t in threading.enumerate()):
        return False
    # pytest's fd capture holds fd 2 during a test: the stacks go to a file
    dump = open(os.path.join(tempfile.gettempdir(),
                             f"misonet-stall-{os.getpid()}.txt"), "w")
    atexit.register(_drop_if_empty, dump)
    threading.Thread(target=_watch, args=(limit, poll, dump),
                     name=THREAD_NAME, daemon=True).start()
    return True
