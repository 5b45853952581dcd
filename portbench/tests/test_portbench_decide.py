"""The decide-loop cells on the CPU: the port's decisions and maps against
the plain reference, each configuration's control and each fault the
cells can have coming out not correct."""

import pytest

from portbench import deploy, harness
from portbench.runners import decide_loop as dl
from portbench.reference import policies as ref
from portbench.tests.helpers import (ADAPTIVE_DECIDE, SEED, cpu_run,
                                     with_cells_left_out)

CELLS = [ADAPTIVE_DECIDE, "ring-mid-v2.decide-loop"]


def test_adaptive_loop_on_the_bridge_equals_the_reference():
    """Tier ``torch``: the runtime chain, the device bridge and the
    policy kernel's plain version, as on the card but for the device."""
    line = cpu_run(CELLS[0], tier="torch")
    assert line["correct"] is True
    assert line["compared"]["decision_mismatches"]["value"] == 0
    assert line["compared"]["map_mismatches"]["value"] == 0


def test_adaptive_loop_is_the_papers_loop_over_the_pinned_map():
    """One tuner and one profiler, sharing ``adapt_map`` through the
    pinned namespace, as the paper's section 5.3 loop is attached."""
    c = harness.find_cell(with_cells_left_out(), CELLS[0])
    rt, _ = deploy.build(c.config, "jit")
    assert [l.name for l in rt.chain("tuner")] == ["adapt_tuner"]
    assert [l.name for l in rt.chain("profiler")] == ["adapt_profiler"]
    assert rt.maps.is_pinned("adapt_map")


@pytest.mark.parametrize("cell", CELLS)
def test_host_tier_equals_the_reference(cell):
    line = cpu_run(cell, sizes={"max_blocks": 2}, seconds=600.0)
    assert line["correct"] is True and line["attempted"] == 8192


@pytest.mark.parametrize("cell", CELLS)
def test_control_in_the_programs_place_is_not_correct(cell):
    c = harness.find_cell(with_cells_left_out(), cell)
    dec, maps = dl.control_run(c.config, c.mix, SEED, 4096)
    got = {x.name: x for x in dl.compare(c.config, c.mix, SEED, dec, maps)}
    assert not all(x.ok for x in got.values())
    assert got["decision_mismatches"].value > 0


@pytest.mark.parametrize("cell,fault,number", [
    (CELLS[0], "altered_decision", "decision_mismatches"),
    (CELLS[0], "frozen_feed", "map_mismatches"),
    (CELLS[1], "altered_decision", "decision_mismatches")])
def test_a_broken_path_is_not_correct(cell, fault, number):
    line = cpu_run(cell, fault=fault)
    assert line["correct"] is False
    assert line["compared"][number]["value"] > 0


def test_reference_policies_follow_their_source():
    dep = ref.Deployment({"attach": [{"program": "ring_mid_v2",
                                      "priority": 0}]})
    mib = 1 << 20
    assert dep.decide(0, 2 * mib, 8, "dp")[1:4] == (0, ref.SIMPLE, 8)
    assert dep.decide(0, 32 * mib, 8, "dp")[1:4] == (ref.RING, ref.LL128,
                                                     32)
    assert dep.decide(0, 64 * mib, 8, "dp")[1:4] == (ref.RING, ref.SIMPLE,
                                                     32)
    assert dep.decide(0, 256 * mib, 8, "dp")[8] is False
    loop = ref.Deployment({"attach": [
        {"program": "adapt_tuner", "priority": 0},
        {"program": "adapt_profiler", "priority": 0}]})
    d = loop.decide(0, 8 * mib, 8, "dp")
    assert d[1:4] == (0, ref.SIMPLE, 2) and d[8] is True
    loop.feed(d, 2_000_000)
    row = loop.maps["adapt_map"].lookup(d[7] % 64)
    assert row == [2_000_000, 2, 1]
    assert loop.decide(0, 8 * mib, 8, "dp")[3] == 2    # backs off, floor 2
