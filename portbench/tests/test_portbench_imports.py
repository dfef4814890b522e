"""What the benchmark loads: no module whose top-level name is `jax`,
`jaxlib`, `flax` or `city_rollup_tpu` (compared whole: the port's
`city_rollup_tpu_torch` begins with the JAX package's name), and a
reference that loads nothing of the port."""

import ast
import json
import subprocess
import sys

import pytest

from portbench import harness

from conftest import REPO

FORBIDDEN = {"jax", "jaxlib", "flax", "city_rollup_tpu"}


def loaded_top_names(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", code + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        cwd=REPO, capture_output=True, text=True, check=True)
    return set(json.loads(out.stdout.splitlines()[-1]))


def test_the_harness_loads_no_jax_and_no_jax_package():
    names = loaded_top_names(
        "import portbench.harness, portbench.probes, portbench.control\n"
        "import portbench.ref.judge\n"
        "prog = portbench.harness.Program()")
    assert "city_rollup_tpu_torch" in names
    assert not names & FORBIDDEN


def test_the_reference_loads_nothing_of_the_port():
    names = loaded_top_names(
        "import portbench.ref.judge, portbench.traffic, portbench.bounds")
    assert not names & (FORBIDDEN | {"city_rollup_tpu_torch"})


@pytest.mark.parametrize("path", sorted(
    p.relative_to(REPO).as_posix()
    for p in (REPO / "portbench" / "ref").rglob("*.py")))
def test_reference_sources_import_only_themselves(path):
    tree = ast.parse((REPO / path).read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.level == 0:
            top = node.module.split(".")[0]
        elif isinstance(node, ast.Import):
            top = node.names[0].name.split(".")[0]
        else:
            continue
        assert top not in FORBIDDEN | {"city_rollup_tpu_torch"}, path


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "city_rollup_tpu_torch_like", sys)
    assert "city_rollup_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "city_rollup_tpu", sys)
    assert harness.forbidden_modules() == ["city_rollup_tpu"]
