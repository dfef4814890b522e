"""BENCHMARK.json against the benchmark's contract, and the harness's
lookup by name: every configuration, mix and metric is a file of its own,
and a new one is taken up without an edit to an existing file."""

import hashlib
import json
import re

import pytest

from portbench import manifest, traffic

from conftest import REPO

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads",
        "end_to_end", "per_layer"}


@pytest.fixture(scope="module")
def bench():
    return manifest.load(REPO)


def test_top_level_keys_and_limits(bench):
    assert set(bench) == KEYS
    assert 1 <= bench["run_seconds"] <= 51
    assert 1 <= len(bench["paths"]) <= 16
    for path in bench["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", path)
        assert not path.startswith("/") and ".." not in path.split("/")
    assert len(json.dumps(bench)) < 64 * 1024
    assert bench["command"][1] == "portbench/run.py"


def test_names_and_units_use_the_allowed_characters(bench):
    names = ([c["name"] for c in bench["configs"]] +
             [w["name"] for w in bench["workloads"]] +
             [m["name"] for m in bench["end_to_end"] + bench["per_layer"]])
    assert len(names) == len(set(names))
    for name in names:
        assert NAME.fullmatch(name), name
    for w in bench["workloads"]:
        assert NAME.fullmatch(w["config"]) and NAME.fullmatch(w["traffic"])
        assert w["chips"] in (1, 4) and 1 <= len(w["why"]) <= 200
    for c in bench["configs"]:
        assert all(NAME.fullmatch(k) for k in c["reduced"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.fullmatch(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")


def test_metrics_follow_the_contract(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    assert "setup_s" in e2e and e2e["setup_s"]["bound"] <= 0.25
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    layers = {}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e
        assert set(m.get("workloads", cells)) <= cells
        layers.setdefault(m["layer"].split(" ")[0], set()).add(m["layer"])
        if m["name"].endswith("_roofline"):
            assert m["unit"] == "%"
    # metrics of one layer name it letter for letter
    assert all(len(v) == 1 for v in layers.values())
    for w in bench["workloads"]:
        per_layer = [m for m in bench["per_layer"]
                     if w["name"] in m.get("workloads", cells)]
        assert per_layer
        reported = {m["name"] for m in bench["end_to_end"]
                    if w["name"] in m.get("workloads", cells)}
        assert "setup_s" in reported and len(reported) >= 2
        # each per-layer metric moves an end-to-end metric its cell reports
        assert {m["moves"] for m in per_layer} <= reported, w["name"]


def test_each_cell_configuration_and_metric_is_found_by_name(bench):
    used = set()
    for w in bench["workloads"]:
        cell = manifest.cell(bench, w["name"])
        assert cell.config["name"] == w["config"]
        assert callable(manifest.work(cell.traffic["work"]).start)
        used.add(w["config"])
    for c in bench["configs"]:
        assert c["name"] in used
        assert c["file"] == f"portbench/configs/{c['name']}.json"
        assert (REPO / c["file"]).is_file()
        assert manifest.read_json(REPO / c["file"])["reduced"] == \
            c["reduced"]
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert callable(manifest.reader(m["name"]))


def test_the_generator_gives_every_seed_the_same_sizes(bench):
    for w in bench["workloads"]:
        mix = manifest.cell(bench, w["name"]).traffic
        shapes = set()
        for seed in (0, 2 ** 31 + 7, 2 ** 40 + 3):
            plain = traffic.generate(mix, seed)
            shapes.add(tuple(tuple(sorted(
                (k, len(v)) for k, v in b["requests"].items()))
                for b in plain["blocks"]))
        assert len(shapes) == 1
        assert traffic.generate(mix, 5) == traffic.generate(mix, 5)


def _digests(root):
    return {p.relative_to(root): hashlib.sha256(p.read_bytes()).hexdigest()
            for p in sorted(root.rglob("*")) if p.is_file()}


def test_new_files_are_taken_up_without_an_edit(bench_copy):
    root = bench_copy.parent
    before = _digests(root)
    cfg = json.loads((bench_copy / "configs" /
                      "city_default.family_b.json").read_text())
    cfg["name"] = "city_throwaway.family_b"
    (bench_copy / "configs" / "city_throwaway.family_b.json").write_text(
        json.dumps(cfg))
    mix = json.loads((bench_copy / "traffic" /
                      "family_b.leaf_single.json").read_text())
    mix["per_block"] = {"add_deposit": 4}
    (bench_copy / "traffic" / "throwaway.mix.json").write_text(
        json.dumps(mix))
    (bench_copy / "metrics" / "throwaway.calls.py").write_text(
        "def read(run):\n    return float(len(run.calls)) or None\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["configs"].append({"name": "city_throwaway.family_b",
                         "source": "test", "reduced": [], "why": "test",
                         "file": "portbench/configs/"
                                 "city_throwaway.family_b.json"})
    m["workloads"].append({"name": "throwaway.cell",
                           "config": "city_throwaway.family_b",
                           "traffic": "throwaway.mix", "chips": 1,
                           "why": "test"})
    m["per_layer"].append({"name": "throwaway.calls", "unit": "calls",
                           "better": "higher", "source": "program_counter",
                           "layer": "worker (rollup/worker.py)",
                           "moves": "leaf_proofs_per_s",
                           "workloads": ["throwaway.cell"]})
    (root / "BENCHMARK.json").write_text(json.dumps(m))

    cell = manifest.cell(manifest.load(root), "throwaway.cell", bench_copy)
    assert cell.config["name"] == "city_throwaway.family_b"
    assert cell.traffic["per_block"] == {"add_deposit": 4}
    assert [x["name"] for x in cell.per_layer][-1] == "throwaway.calls"
    read = manifest.reader("throwaway.calls", bench_copy)

    class Run:
        calls = [(0, 1, 1), (1, 2, 1)]
    assert read(Run) == 2.0
    plain = traffic.generate(cell.traffic, 11)
    assert [len(b["requests"]["add_deposit"]) for b in plain["blocks"]][1:] \
        == [4] * cell.traffic["blocks"]
    after = _digests(root)
    changed = {p for p in before if before[p] != after.get(p)}
    assert changed == {__import__("pathlib").Path("BENCHMARK.json")}


WORK = '''
class Work:
    """A throwaway kind of work: `jobs` calls of one answer each."""

    def __init__(self, ctx):
        self.ctx, self.left, self.answers = ctx, int(ctx.mix["jobs"]), []

    def pending(self):
        return self.left

    def call(self):
        self.left -= 1
        self.answers.append(self.ctx.seed % 7)
        return 1

    def jobs_popped(self):
        return len(self.answers)

    def backlog_left(self):
        return self.left

    def counters(self):
        return {"answers": list(self.answers)}

    def outputs(self, first):
        return [{"job": str(i), "answer": a, "in_window": i >= first}
                for i, a in enumerate(self.answers)]

    def free(self):
        pass

    def judge(self, outputs, cache_dir):
        wrong = [o["job"] for o in outputs
                 if o["answer"] != self.ctx.seed % 7]
        return {"answers_wrong": {"value": len(wrong), "limit": 0},
                "_failed_jobs": set(wrong)}


def start(ctx):
    return Work(ctx)
'''


def test_a_new_kind_of_work_runs_from_new_files_only(bench_copy):
    """A kind of work, a mix naming it and a metric reading its counter,
    added as files, run end to end with no edit to an existing file."""
    import time

    from portbench import harness
    root = bench_copy.parent
    before = _digests(root)
    (bench_copy / "work" / "throwaway_work.py").write_text(WORK)
    (bench_copy / "traffic" / "throwaway.work.json").write_text(
        json.dumps({"work": "throwaway_work", "jobs": 5}))
    (bench_copy / "metrics" / "throwaway.answers.py").write_text(
        "def read(run):\n    return float(len(run.program['answers']))\n")
    m = json.loads((root / "BENCHMARK.json").read_text())
    m["workloads"].append({"name": "throwaway.cell",
                           "config": "city_default.family_b",
                           "traffic": "throwaway.work", "chips": 1,
                           "why": "test"})
    m["per_layer"].append({"name": "throwaway.answers", "unit": "answers",
                           "better": "higher", "source": "program_counter",
                           "layer": "worker (rollup/worker.py)",
                           "moves": "leaf_proofs_per_s",
                           "workloads": ["throwaway.cell"]})
    for e in m["end_to_end"]:
        if e["name"] == "leaf_proofs_per_s":
            e["workloads"].append("throwaway.cell")
    (root / "BENCHMARK.json").write_text(json.dumps(m))
    for trace in (False, True):
        res = harness.run_cell("throwaway.cell", 2 ** 31 + 3, 60.0, trace,
                               time.perf_counter(), root, device="cpu",
                               base=bench_copy)
        assert res["correct"] and res["attempted"] == 4
        assert res["window"]["calls"] == 4
        assert res["checks"] == {"answers_wrong": {"value": 0, "limit": 0}}
        if trace:
            assert res["metrics"]["throwaway.answers"]["value"] == 4.0
        else:
            assert set(res["metrics"]) == {"leaf_proofs_per_s", "setup_s"}
    changed = {p for p in before if before[p] != _digests(root).get(p)}
    assert changed == {__import__("pathlib").Path("BENCHMARK.json")}
