"""The harness's general part: cells, mixes, models and metrics found by
name; the result line; the isolation check; a run without the card or
without the port."""

import ast
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path


from portbench import harness
from portbench.tests.helpers import cpu_run

PKG = Path(harness.__file__).resolve().parent
ROOT = PKG.parent


def _bench():
    return harness.load_bench()


def test_benchmark_json_names_files_that_exist():
    b = _bench()
    for c in b["configs"]:
        assert (ROOT / c["file"]).is_file()
    for w in b["workloads"]:
        cell = harness.find_cell(b, w["name"])
        assert (PKG / "runners" / f"{cell.mix['kind']}.py").is_file()
    for m in b["per_layer"]:
        assert callable(harness.reader(m["name"]))
        assert m["moves"] in {e["name"] for e in b["end_to_end"]}


def test_new_files_are_found_without_an_edit(tmp_path):
    """A configuration, a mix, a model and a metric added as files and
    entries: the harness finds each by its name."""
    root = tmp_path
    pkg = root / "portbench"
    for sub in ("configs", "mixes", "models", "metrics"):
        (pkg / sub).mkdir(parents=True)
    conf = json.loads((PKG / "configs" / "ring-mid-v2.json").read_text())
    (pkg / "configs" / "other.json").write_text(json.dumps(
        dict(conf, n_ranks=4)))
    mix = json.loads((PKG / "mixes" / "train-qwen3-1.7b.json").read_text())
    (pkg / "mixes" / "train-tiny.json").write_text(json.dumps(
        dict(mix, model="tiny")))
    (pkg / "models" / "tiny.json").write_text(json.dumps(
        {"name": "tiny", "hidden_size": 8}))
    (pkg / "metrics" / "steps_seen.py").write_text(
        "def read(obs):\n    return obs.get('steps')\n")
    b = _bench()
    b["configs"].append({"name": "other", "source": "x",
                         "file": "portbench/configs/other.json",
                         "reduced": [], "why": "x"})
    b["workloads"].append({"name": "other.train-tiny", "config": "other",
                           "traffic": "train-tiny", "chips": 1, "why": "x"})
    cell = harness.find_cell(b, "other.train-tiny", root=root)
    assert cell.config["n_ranks"] == 4
    assert cell.mix["model"] == "tiny" and cell.model["hidden_size"] == 8
    assert harness.runner(cell.mix["kind"]).__name__.endswith(".train")
    assert harness.reader("steps_seen", pkg=pkg)({"steps": 7}) == 7


def test_metrics_of_a_cell_follow_their_lists():
    b = _bench()
    e2e = {m["name"] for m in harness.cell_metrics_e2e(
        b, "ring-mid-v2.decide-loop")}
    assert e2e == {"decisions_per_s", "setup_s"}
    per = {m["name"] for m in harness.cell_metrics(
        b, "ring-mid-v2.decide-loop")}
    assert "train_mfu" not in per and "cache_served_share" in per
    b["per_layer"].append({"name": "x", "unit": "%", "better": "lower",
                           "source": "host_clock", "layer": "device",
                           "moves": "setup_s"})
    assert "x" in {m["name"] for m in harness.cell_metrics(
        b, "adaptive-loop.train-qwen3-1.7b")}


def test_result_line_fields(capsys):
    line = cpu_run("ring-mid-v2.decide-loop")
    assert list(line)[:5] == ["correct", "attempted", "failed", "metrics",
                              "device"]
    assert list(line)[-1] == "compared"
    assert line["correct"] is True and line["failed"] == 0
    assert line["attempted"] >= 256
    assert set(line["metrics"]) == {"decisions_per_s", "setup_s"}
    for v in line["metrics"].values():
        assert v["value"] > 0 and v["unit"]
    assert {"platform", "kind", "count", "memory_peak_bytes"} <= \
        set(line["device"])
    harness.emit(line)
    out, err = capsys.readouterr()
    assert json.loads(out.strip().splitlines()[-1]) == line
    assert err.strip().splitlines()[-1].startswith(
        "compared map_mismatches: 0 limit 0")


def test_traced_line_carries_per_layer_metrics():
    line = cpu_run("ring-mid-v2.decide-loop", trace=True)
    m = line["metrics"]
    assert "decisions_per_s" not in m
    assert m["cache_served_share"]["value"] > 90
    assert {"busy_s", "window_s"} <= set(line["device"])
    assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}


def test_forbidden_modules_compare_whole_top_level_names():
    got = harness.forbidden_modules(
        ["repro_torch", "repro_torch.core", "reprox", "repro",
         "repro.core.vm", "jax", "jaxlib.xla", "jax_tools", "flax.linen",
         "portbench"])
    assert got == ["flax.linen", "jax", "jaxlib.xla", "repro",
                   "repro.core.vm"]


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_harness_sources_keep_apart():
    """Nothing of the harness imports JAX, the JAX package or the JAX
    package's benchmarks; the references import nothing of the port."""
    for path in PKG.rglob("*.py"):
        tops = {m.split(".")[0] for m in _imports(path) if m}
        assert not tops & {"jax", "jaxlib", "flax", "repro", "benchmarks"}, \
            path
        text = path.read_text()
        # spelled in two parts so this file does not name them itself
        assert "BENCH_" + "table1" not in text
        assert '"bench' + 'marks/' not in text
        if path.parent.name == "reference":
            assert "repro_torch" not in tops, path


def test_a_run_loads_no_forbidden_module():
    code = ("import sys, time; sys.path[:0] = [%r, %r]\n"
            "from portbench.tests.helpers import cpu_run\n"
            "cpu_run('adaptive-loop.decide-loop')\n"
            "from portbench import harness\n"
            "print(harness.forbidden_modules(list(sys.modules)))\n"
            % (str(ROOT), str(ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "[]"


def _cli(cwd, env=None):
    return subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         "ring-mid-v2.decide-loop", "--seed", str(2**31 + 3),
         "--seconds", "1", "--trace", "0"],
        cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_without_a_card_the_run_fails_and_prints_nothing():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = _cli(ROOT, env)
    assert out.returncode != 0 and out.stdout == ""
    assert "CUDA" in out.stderr


def test_without_the_port_the_run_fails_and_prints_nothing(tmp_path):
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(PKG, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _cli(tmp_path, env)
    assert out.returncode != 0 and out.stdout == ""
    assert "repro_torch" in out.stderr
