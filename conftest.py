"""Settings for the test processes, and a time limit for every test under
``tests/``.

pytest loads this file before ``tests/conftest.py`` whenever it runs from
the repository (``python -m pytest tests/``).

Threads.  Under pytest-xdist several test processes share one machine's
cores.  torch's intra-op threads spin while they wait, so with a thread per
core in every process the port's CPU paths ran tens of times slower than on
one thread; XLA's CPU runtime also ran the JAX package's tests slower with
a thread pool per process.  So, unless ``OMP_NUM_THREADS`` is set, each
worker gives torch its share of the cores it may run on, and XLA one
thread.

Compile cache.  Many tests of the JAX package compile the same programs,
in different files and so in different processes.  One persistent
compilation cache, made in the temporary directory for the run and
removed at its end, lets each program compile once per run.  An
``JAX_COMPILATION_CACHE_DIR`` already set is used as it is.

Left out of tier-1.  ``JAX_ONLY_SLOW`` lists tests that check only the
JAX package, which no change to the port touches, at the highest cost per
test; they are marked ``slow`` at collection, so ``-m 'not slow'`` leaves
them out and ``-m slow`` runs them.  The test files themselves are not
changed.

Time limits.  Every test not marked ``slow`` gets ``DEFAULT_LIMIT`` seconds
for its setup and again for its call; ``@pytest.mark.limit(seconds)`` sets
another.  At the limit SIGALRM fails the test wherever control returns to
Python; a call stuck in C++ (an XLA compile) is ended ``HARD_STOP`` seconds
later by faulthandler, which dumps the stacks and exits the process (under
xdist the worker is replaced and the test reported as failed).
"""

import atexit
import contextlib
import faulthandler
import fnmatch
import os
import pathlib
import shutil
import signal
import tempfile
import threading

import pytest

DEFAULT_LIMIT = 240
HARD_STOP = 60
TESTS = pathlib.Path(__file__).resolve().parent / "tests"


def _cores():
    try:
        return len(os.sched_getaffinity(0))
    except AttributeError:                      # no affinity on this platform
        return os.cpu_count() or 1


_workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
if _workers > 1 and "OMP_NUM_THREADS" not in os.environ:
    import torch

    torch.set_num_threads(max(1, _cores() // _workers))
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "") + " --xla_cpu_multi_thread_eigen=false").strip()

if "JAX_COMPILATION_CACHE_DIR" not in os.environ:     # the first process of the run; xdist's workers inherit it
    _cache = tempfile.mkdtemp(prefix="jax-compile-cache-")
    atexit.register(shutil.rmtree, _cache, ignore_errors=True)
    os.environ["JAX_COMPILATION_CACHE_DIR"] = _cache
    os.environ.setdefault("JAX_PERSISTENT_CACHE_MIN_COMPILE_TIME_SECS", "0.5")


# Node-id patterns (fnmatch; ``[[]`` and ``[]]`` are literal brackets), in
# order of cost per test in the 6-worker tier-1 run.
JAX_ONLY_SLOW = (
    "tests/test_dist_ntt.py::*[[]65536[]]",
    "tests/test_shard_ops.py::*",
    "tests/test_large_n.py::*",
    "tests/test_op_battery.py::*",
    "tests/test_mxu_ntt.py::*",
    "tests/test_debug_mode.py::*",
    "tests/test_pallas_switch_key.py::*",
    "tests/test_boundaries.py::*",
    "tests/test_batch_surface.py::*",
)


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    for item in items:
        if any(fnmatch.fnmatchcase(item.nodeid, pattern) for pattern in JAX_ONLY_SLOW):
            item.add_marker(pytest.mark.slow)


def _limit(item):
    if not item.path.is_relative_to(TESTS):
        return None
    marker = item.get_closest_marker("limit")
    if marker is not None:
        return float(marker.args[0])
    return None if item.get_closest_marker("slow") else DEFAULT_LIMIT


@contextlib.contextmanager
def _bounded(item, phase):
    limit = _limit(item)
    if limit is None:
        yield
        return

    def expire(signum, frame):
        pytest.fail(f"{item.nodeid} exceeded its time limit of {limit:g} s in {phase}")

    in_main = threading.current_thread() is threading.main_thread()     # signals reach the main thread only
    if in_main:
        previous = signal.signal(signal.SIGALRM, expire)
        signal.setitimer(signal.ITIMER_REAL, limit)
    faulthandler.dump_traceback_later(limit + HARD_STOP, exit=True)
    try:
        yield
    finally:
        faulthandler.cancel_dump_traceback_later()
        if in_main:
            signal.setitimer(signal.ITIMER_REAL, 0)
            signal.signal(signal.SIGALRM, previous)


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_setup(item):
    with _bounded(item, "setup"):
        yield


@pytest.hookimpl(hookwrapper=True)
def pytest_runtest_call(item):
    with _bounded(item, "call"):
        yield
