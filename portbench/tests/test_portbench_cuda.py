"""On the card: a sound run of each cell is correct, and the control (one
FRI query round fewer than the configuration states) is not, at the cells'
own sizes. Marked ``cuda``; each test decides in the ``cuda`` fixture
whether a card is there. A run takes minutes (the family build alone is
~40 s): run with ``python -m pytest -m cuda portbench/tests -q``."""

import json
import subprocess
import sys

import pytest

from portbench import manifest

from conftest import REPO

SECONDS = 10
SEED = 2 ** 31 + 4242


def cells():
    return [w["name"] for w in manifest.load(REPO)["workloads"]]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", cells())
def test_a_sound_run_is_correct(cuda, cell):
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(SEED), "--seconds", str(SECONDS), "--trace", "0"],
        cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.splitlines()[-1])
    assert res["correct"], res["checks"]
    assert res["device"]["platform"] == "gpu"


@pytest.mark.cuda
@pytest.mark.parametrize("cell", cells())
def test_the_control_is_not_correct(cuda, cell):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.control", "--workload", cell,
         "--seconds", str(SECONDS), "--seeds", str(SEED),
         "--mutation", "fewer_queries"],
        cwd=REPO, capture_output=True, text=True, timeout=1200)
    assert out.returncode == 0, out.stdout[-4000:] + out.stderr[-4000:]
    res = json.loads(out.stdout.splitlines()[-1])
    assert not res["correct"]
    assert res["checks"]["proofs_rejected"]["value"] > 0
