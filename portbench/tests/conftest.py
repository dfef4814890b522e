"""Shared fixtures of the benchmark's tests: a temporary copy of the
benchmark (BENCHMARK.json and portbench/) into which a test adds files."""

import shutil
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parents[2]


def copy_benchmark(dest: Path) -> Path:
    """dest/BENCHMARK.json and dest/portbench/ (without caches and tests);
    returns dest/portbench."""
    dest.mkdir(parents=True, exist_ok=True)
    shutil.copy(REPO / "BENCHMARK.json", dest / "BENCHMARK.json")
    shutil.copytree(REPO / "portbench", dest / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    return dest / "portbench"


@pytest.fixture
def bench_copy(tmp_path):
    return copy_benchmark(tmp_path / "checkout")


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
