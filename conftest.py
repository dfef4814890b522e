"""The test suite's environment, loaded by pytest before `tests/conftest.py`
(which builds `XLA_FLAGS` on top of what this file sets and then imports
jax).

- Under pytest-xdist each worker gets an equal share of the CPUs for torch's
  threads and XLA:CPU's Eigen threads (`thread_budget`): with every worker's
  torch at the machine's full width, a test beside busy workers ran up to 70
  times slower than alone.
- Every test's set-up and call run under a time limit (`time_limit`), so
  that one stuck test fails by name instead of eating the suite's clock.
- A `smoke` test is also `slow`, the heaviest files run first and those
  that cannot end in time last (`pytest_collection_modifyitems`).
"""

import faulthandler
import os
import pathlib
import signal
import tempfile

import pytest


def thread_budget(environ=os.environ, cpus=None):
    """Threads one xdist worker may use, or None where nothing is capped:
    outside xdist, and on the real device (CITY_TPU_TESTS=1). `cpus`
    defaults to the CPUs this process may run on."""
    workers = environ.get("PYTEST_XDIST_WORKER_COUNT")
    if not workers or environ.get("CITY_TPU_TESTS"):
        return None
    if cpus is None:
        cpus = len(os.sched_getaffinity(0))
    return max(1, cpus // int(workers))


THREADS = thread_budget()
if THREADS is not None:
    # Before anything imports torch: its pools read these at start-up.
    os.environ["OMP_NUM_THREADS"] = os.environ["MKL_NUM_THREADS"] = \
        str(THREADS)
    # Eigen's intra-op threads. No XLA flag sizes the CPU client's own
    # pool, and a token without "--" (intra_op_parallelism_threads=1)
    # makes XLA ignore every flag after it.
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_cpu_multi_thread_eigen=false").strip()
    import torch
    torch.set_num_threads(THREADS)


# -- which tests run, and in what order ------------------------------------

# The files whose tests hold one xdist worker longest, longest first: they
# run first, so that the run's end does not wait on one that started late.
# `--dist loadfile` hands out whole files, by default those with the most
# tests first, which put these (2-6 tests each) last.
HEAVY_FIRST = ("test_signature.py", "test_sha256.py", "test_u32.py",
               "test_secp_circuit.py", "test_snark.py", "test_torch_snark.py",
               "test_recursion.py")
# Files that cannot end inside tier-1's time run after all others, so that
# no file waits behind them on their worker. test_verify_template.py's
# proof grinds 16 proof-of-work bits in one call of 2^17 Poseidon
# permutations, ~17 min alone at XLA's optimization level 1.
LAST = ("test_verify_template.py",)


def pytest_configure(config):
    if hasattr(config.option, "loadscopereorder"):
        config.option.loadscopereorder = False


@pytest.hookimpl(tryfirst=True)
def pytest_collection_modifyitems(items):
    # pytest.ini's `addopts = -m "not slow and not smoke"` is replaced by
    # any -m on the command line, and tier-1 passes -m 'not slow'. Marking
    # every smoke test slow as well, before -m deselects, keeps the smoke
    # tier out of tier-1 while `-m smoke` still selects it.
    for item in items:
        if item.get_closest_marker("smoke"):
            item.add_marker("slow")
    rank = {name: i for i, name in enumerate(HEAVY_FIRST)}
    rank.update(dict.fromkeys(LAST, len(HEAVY_FIRST) + 1))
    items.sort(key=lambda item: rank.get(item.path.name, len(HEAVY_FIRST)))


# -- per-test time limit ----------------------------------------------------

# A safety net, not a bound on a test's cost: well above the slowest
# passing phase of a tier-1 test beside busy workers (~540 s). A signal
# ends the test, so a native call (one XLA execution) that outlasts the
# limit runs on to its end first.
DEFAULT_TIME_LIMIT = 900
# The tier-1 suite's directory; tests elsewhere (portbench/tests) run
# unlimited.
LIMITED = pathlib.Path(__file__).parent / "tests"


def time_limit(item):
    """Seconds each of the test's set-up and call may take, or 0 for none:
    tests outside `LIMITED` and those marked `slow` or `smoke` run
    unlimited."""
    if (LIMITED not in item.path.parents or item.get_closest_marker("slow")
            or item.get_closest_marker("smoke")):
        return 0
    return DEFAULT_TIME_LIMIT


def _over_limit(item, limit):
    def handler(signum, frame):
        with tempfile.TemporaryFile("w+") as f:
            faulthandler.dump_traceback(f)
            f.seek(0)
            where = f.read()
        pytest.fail(f"{item.nodeid} ran past its time limit of {limit:g} s;"
                    f" it was at:\n{where}", pytrace=False)
    return handler


def _run_with_limit(item):
    limit = time_limit(item)
    if not limit:
        return (yield)
    old = signal.signal(signal.SIGALRM, _over_limit(item, limit))
    signal.setitimer(signal.ITIMER_REAL, limit)
    try:
        return (yield)
    finally:
        signal.setitimer(signal.ITIMER_REAL, 0)
        signal.signal(signal.SIGALRM, old)


@pytest.hookimpl(wrapper=True)
def pytest_runtest_setup(item):
    return (yield from _run_with_limit(item))


@pytest.hookimpl(wrapper=True)
def pytest_runtest_call(item):
    return (yield from _run_with_limit(item))
