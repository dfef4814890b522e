"""The suite's environment in the repo's root `conftest.py`: each xdist
worker's CPU-thread budget, the per-test time limit, the smoke tier's
`slow` mark and the order of the files."""

import os
import textwrap
from pathlib import Path
from types import SimpleNamespace

import pytest
import torch

pytest_plugins = ["pytester"]

ENV_PATH = Path(__file__).resolve().parents[1] / "conftest.py"


@pytest.fixture
def env(request):
    """The root conftest module, as pytest loaded it."""
    return request.config.pluginmanager.get_plugin(str(ENV_PATH))


@pytest.mark.parametrize("environ, cpus, want", [
    ({}, 8, None),
    ({"PYTEST_XDIST_WORKER_COUNT": "6"}, 8, 1),
    ({"PYTEST_XDIST_WORKER_COUNT": "2"}, 8, 4),
    ({"PYTEST_XDIST_WORKER_COUNT": "16"}, 8, 1),
    ({"PYTEST_XDIST_WORKER_COUNT": "6", "CITY_TPU_TESTS": "1"}, 8, None),
])
def test_thread_budget(env, environ, cpus, want):
    assert env.thread_budget(environ, cpus) == want


def test_thread_budget_counts_the_cpus_it_may_run_on(env):
    assert env.thread_budget({"PYTEST_XDIST_WORKER_COUNT": "1"}) == \
        len(os.sched_getaffinity(0))


def test_worker_runs_inside_its_budget(env):
    want = env.thread_budget()
    assert env.THREADS == want
    if want is None:
        assert "xla_cpu_multi_thread_eigen" not in os.environ.get(
            "XLA_FLAGS", "")
        return
    assert want == max(1, len(os.sched_getaffinity(0))
                       // int(os.environ["PYTEST_XDIST_WORKER_COUNT"]))
    assert torch.get_num_threads() == want
    assert os.environ["OMP_NUM_THREADS"] == str(want)
    assert os.environ["MKL_NUM_THREADS"] == str(want)
    assert "--xla_cpu_multi_thread_eigen=false" in os.environ["XLA_FLAGS"]


@pytest.mark.parametrize("where, marks, limited", [
    ("tests/test_x.py", (), True),
    ("tests/test_x.py", ("slow",), False),
    ("tests/test_x.py", ("smoke",), False),
    ("portbench/tests/test_x.py", (), False),
])
def test_time_limit_of_an_item(env, where, marks, limited):
    item = SimpleNamespace(path=ENV_PATH.parent / where,
                           get_closest_marker=lambda name: name in marks)
    assert env.time_limit(item) == (env.DEFAULT_TIME_LIMIT if limited else 0)


@pytest.fixture
def inner(pytester, monkeypatch):
    """A pytester directory whose conftest loads the root conftest's hooks
    with a default time limit of 1 s on its own tests."""
    for name in ("PYTEST_XDIST_WORKER", "PYTEST_XDIST_WORKER_COUNT"):
        monkeypatch.delenv(name, raising=False)
    pytester.makeini("""
        [pytest]
        markers =
            slow: slow
            smoke: smoke
    """)
    pytester.makeconftest(f"""
        import importlib.util

        spec = importlib.util.spec_from_file_location(
            "suite_env", {str(ENV_PATH)!r})
        env = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(env)
        env.DEFAULT_TIME_LIMIT = 1
        env.LIMITED = env.pathlib.Path(__file__).parent
        pytest_collection_modifyitems = env.pytest_collection_modifyitems
        pytest_runtest_setup = env.pytest_runtest_setup
        pytest_runtest_call = env.pytest_runtest_call
    """)
    return pytester


def test_time_limit_fails_only_the_late_test(inner):
    inner.makepyfile(test_inner=textwrap.dedent("""
        import time

        def test_sleeps_past_its_limit():
            time.sleep(120)

        def test_after_it():
            pass
    """))
    result = inner.runpytest_subprocess("-p", "no:cacheprovider")
    result.assert_outcomes(passed=1, failed=1)
    result.stdout.fnmatch_lines([
        "*test_inner.py::test_sleeps_past_its_limit ran past its time limit"
        " of 1 s*",
        "*in test_sleeps_past_its_limit*",
    ])
    assert result.duration < 60


def test_heavy_files_run_first_and_the_last_last(inner):
    inner.makeconftest(inner.path.joinpath("conftest.py").read_text() + """
env.HEAVY_FIRST = ("test_c.py", "test_b.py")
env.LAST = ("test_a.py",)
""")
    for name in "abcd":
        inner.makepyfile(**{f"test_{name}": "def test_it():\n    pass\n"})
    result = inner.runpytest_subprocess("-p", "no:cacheprovider",
                                        "--collect-only", "-q")
    result.stdout.fnmatch_lines(["test_c.py::test_it", "test_b.py::test_it",
                                 "test_d.py::test_it", "test_a.py::test_it"],
                                consecutive=True)


def test_smoke_test_is_slow_and_unlimited(inner):
    inner.makepyfile(test_inner=textwrap.dedent("""
        import time
        import pytest

        @pytest.mark.smoke
        def test_smoke_sleeps_past_the_default_limit():
            time.sleep(2)

        def test_plain():
            pass
    """))
    tier1 = inner.runpytest_subprocess("-p", "no:cacheprovider",
                                       "-m", "not slow")
    tier1.assert_outcomes(passed=1, deselected=1)
    smoke = inner.runpytest_subprocess("-p", "no:cacheprovider", "-m", "smoke")
    smoke.assert_outcomes(passed=1, deselected=1)
    slow = inner.runpytest_subprocess("-p", "no:cacheprovider", "-m", "slow")
    slow.assert_outcomes(passed=1, deselected=1)
