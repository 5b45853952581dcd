"""The Moonlight cell on the CPU at a size a test can hold: the plain
reference against the port's model, the weight plan against the port's
tree, the FLOP arithmetic against ``FlopCounterMode``, the cell correct,
the control and the faults not correct, and the two readers of the
expert layer's span and counters."""

import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from portbench import faults, harness, moonlight
from portbench.reference import moonlight as ref
from portbench.runners import train_expert_share as drv
from portbench.tests.helpers import SEED, cpu_run
from portbench.tests.small_moonlight import FAULTS as BIAS_FAULTS
from portbench.tests.small_moonlight import (CELL, SMALL, cell, port_tree,
                                             small_config, small_model)
from portbench.traffic import TokenCorpus
from repro_torch.models.layers import MeshAxes

AX = MeshAxes()


def _batch(model, B=2, S=32):
    b = TokenCorpus(model["vocab_size"], 5).batch(0, B, S)
    return {k: torch.as_tensor(v).long() for k, v in b.items()}


def test_plan_is_the_ports_tree():
    from repro_torch.models import init_params
    from repro_torch.models.transformer import tree_leaves
    model = small_model()
    params, _ = init_params(0, small_config(model), AX, device="cpu")
    assert [tuple(t.shape) for t in tree_leaves(params)] == \
        [s for _, s, _ in moonlight.plan(model)]
    assert list(moonlight.make(model, SEED, "cpu")) == \
        [p for p, _, _ in moonlight.plan(model)]


def test_full_size_plan_is_the_stated_share():
    """27 layers, every published width, 8 of 64 experts, 20,480 of the
    vocabulary: 2.78 billion parameters, the port's count."""
    model = cell().model
    n = sum(torch.Size(s).numel() for _, s, _ in moonlight.plan(model))
    assert n == drv.port_config(model, {}).param_count()
    assert 2.77e9 < n < 2.79e9


def test_reference_loss_equals_the_ports_in_float32():
    from repro_torch.models import loss_fn
    model = small_model()
    W = moonlight.make(model, SEED, "cpu")
    b = _batch(model)
    want = sum(ref.loss(W, b["tokens"][r:r + 1], b["labels"][r:r + 1],
                        model)[0] for r in range(2)) / 2
    got = loss_fn(port_tree(W), b, small_config(model), AX)
    assert abs(float(got) - float(want)) <= 1e-5 * float(want)


def test_flops_equal_the_counter_without_recomputation():
    from repro_torch.models import loss_fn
    model = small_model()
    W = moonlight.make(model, SEED, "cpu")
    for p, t in W.items():
        t.requires_grad_(not p.endswith("router_bias"))
    b = _batch(model)
    loads = []
    counter = FlopCounterMode(display=False)
    with counter:
        loss_fn(port_tree(W), b, small_config(model), AX,
                loads=loads).backward()
    first, held = ref.held(model)
    pairs = float(sum(l[first:first + held].sum() for l in loads))
    assert 0 < pairs < 2 * 32 * 4 * 2
    assert moonlight.flops_per_step(model, 2, 32, pairs) == \
        counter.get_total_flops()


def test_the_cell_at_a_small_size_is_correct():
    line = cpu_run(CELL, sizes=SMALL, seconds=600.0,
                   bench=harness.load_bench())
    assert line["correct"] is True, line["compared"]
    assert line["attempted"] == 2
    assert set(line["metrics"]) == {"train_tokens_per_s", "setup_s"}


@pytest.mark.parametrize("fault", ["frozen_step", "altered_decision",
                                   "half_batch", "skipped_bias_update",
                                   "reversed_bias_update"])
def test_a_broken_step_is_not_correct(fault, monkeypatch):
    for name, plant in BIAS_FAULTS.items():
        monkeypatch.setitem(faults.FAULTS, name, plant)
    line = cpu_run(CELL, sizes=SMALL, seconds=600.0, fault=fault,
                   bench=harness.load_bench())
    assert line["correct"] is False, line["compared"]
    if fault in BIAS_FAULTS:
        bias = line["compared"]["bias_gap"]
        assert bias["value"] > bias["limit"], line["compared"]


def test_control_in_the_programs_place_is_not_correct():
    """The reference in float8 against the reference in float32."""
    model, mix = small_model(), cell().mix
    B, S = SMALL["batch"], SMALL["seq"]
    want = drv.reference_readings(model, mix, SEED, B, S, "cpu")
    ctl = drv.reference_readings(model, mix, SEED, B, S, "cpu",
                                 quantize=True)
    gaps = drv.gaps(ctl, want)
    assert set(gaps) == set(mix["limits"]) - {"decision_mismatches"}
    assert any(gaps[k] > mix["limits"][k] for k in gaps), gaps


def test_traced_run_reads_the_expert_layers_span_and_counters():
    """Two expert layers under remat: each step reads the group sizes
    twice a layer, forward and recompute."""
    line = cpu_run(CELL, sizes=SMALL, seconds=600.0, trace=True,
                   bench=harness.load_bench())
    m = line["metrics"]
    assert m["moe_host_syncs_per_step"]["value"] == 4.0
    assert 0 < m["moe_dispatch_share"]["value"] < 100
    assert 0 < m["train_mfu"]["value"]
    assert line["correct"] is True, line["compared"]
    # the trainer's and the pipeline's spans are there as in the Qwen3
    # cell, for their readers, which BENCHMARK.json names for that cell
    # alone
    obs = {"trace": {"window_s": line["device"]["window_s"]}}
    assert 0 <= harness.reader("train_data_wait_share")(obs) < 100
    assert 0 < harness.reader("data_batch_s")(obs)


def test_readers_find_nothing_without_a_session():
    from repro_torch.obs import trace
    trace.clear()
    obs = {"trace": {"window_s": 1.0, "busy_s": 0.5, "device_events": 1}}
    for name in ("moe_dispatch_share", "moe_host_syncs_per_step"):
        assert harness.reader(name)(obs) is None
