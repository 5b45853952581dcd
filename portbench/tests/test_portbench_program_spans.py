"""The readers of the port's own spans on the CPU: a traced run of each
cell reports its span metrics, each a number (a share between 0 and 100),
and without the port's span store each reader gives None and raises
nothing, as on a port that has no store."""

import sys

import pytest

from portbench import harness
from portbench.tests.helpers import SMALL_TRAIN, cpu_run

DECIDE = "ring-mid-v2.decide-loop"
TRAIN = "adaptive-loop.train-qwen3-1.7b"
METRICS = [(DECIDE, "decide_log_share", "%"),
           (DECIDE, "decide_lookup_share", "%"),
           (TRAIN, "train_data_wait_share", "%"),
           (TRAIN, "data_batch_s", "s")]
RUNS = {DECIDE: {}, TRAIN: {"sizes": SMALL_TRAIN, "seconds": 600.0}}


@pytest.fixture(scope="module")
def lines():
    """One traced run of each cell, made when a test first asks for it."""
    done = {}

    def line(cell):
        if cell not in done:
            done[cell] = cpu_run(cell, trace=True, **RUNS[cell])
        return done[cell]
    return line


@pytest.mark.parametrize("cell,name,unit", METRICS)
def test_a_traced_run_reports_the_span_metric(lines, cell, name, unit):
    line = lines(cell)
    assert line["correct"] is True, line["compared"]
    got = line["metrics"][name]
    assert got["unit"] == unit
    assert got["value"] > 0
    if unit == "%":
        assert got["value"] <= 100


@pytest.mark.parametrize("cell,name,unit", METRICS)
def test_without_the_span_store_the_reader_gives_none(monkeypatch, cell,
                                                      name, unit):
    import repro_torch.obs
    monkeypatch.delattr(repro_torch.obs, "trace", raising=False)
    monkeypatch.setitem(sys.modules, "repro_torch.obs.trace", None)
    obs = {"trace": {"window_s": 3.0, "busy_s": 0.0, "device_events": 1}}
    assert harness.reader(name)(obs) is None


def test_the_span_metrics_name_their_cells():
    bench = harness.load_bench()
    got = {m["name"]: m for m in bench["per_layer"]}
    for cell, name, unit in METRICS:
        m = got[name]
        assert (m["workloads"], m["unit"], m["source"]) == \
            ([cell], unit, "program_span")
        assert name in {x["name"] for x in harness.cell_metrics(bench, cell)}
