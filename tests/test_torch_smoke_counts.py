"""Checks of ``chip_smoke.py`` that rest on counts, on the CPU.

Phase 15 (b) holds a profiled window of captured replays to the
device's own counts (``window_failures``): each branch body's run
counter, the write cursor and ``lat_map``'s decision count must each
move by the window, body by body as the window's algos say.
``torch.profiler`` drops records of replays (ROADMAP C12), so the
trace's record counts are printed and never decide.

Phase 10's bound (``model_bound``) counts an output that shares storage
with an input once: fused RMSNorm without a residual returns x itself
as the residual stream, which moves no byte.  Its L2-cold timings take
turns over input sets (``l2_cold``).
"""

import importlib.util
import re
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
N = 200                      # replays in phase 15's window
ALGOS = [0, 2, 2, 0, 0] * (N // 5)          # default and tree, as on one rank


@pytest.fixture(scope="module")
def smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke_counts", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _counts(bodies=(1018, 0, 0, 0), cursor=1018, decisions=1018) -> dict:
    return {"bodies": list(bodies), "cursor": cursor, "decisions": decisions}


def _after(before, algos=ALGOS, *, body_delta=None, cursor=None,
           decisions=None) -> dict:
    """The counts after ``algos`` ran, one body each, unless told
    otherwise."""
    delta = body_delta or [algos.count(i) for i in range(4)]
    n = len(algos)
    return {"bodies": [b + d for b, d in zip(before["bodies"], delta)],
            "cursor": (before["cursor"] + (n if cursor is None else cursor))
            % (1 << 32),
            "decisions": before["decisions"] + (n if decisions is None
                                                else decisions)}


SEEN = {"kernel": N, "switch": N, "copies": 2 * N, "nccl": 0}


@pytest.mark.parametrize("cursor0", [1018, (1 << 32) - 50])
def test_counts_that_advance_by_the_window_pass(smoke, cursor0):
    """Every count moved by the window, the cursor also across its
    uint32 wrap."""
    before = _counts(cursor=cursor0)
    failed, line = smoke.window_failures(before, _after(before), ALGOS, SEEN)
    assert failed == []
    assert f"bodies +[{ALGOS.count(0)}, 0, {ALGOS.count(2)}, 0]" in line
    assert f"cursor +{N}" in line and f"lat_map +{N}" in line


@pytest.mark.parametrize("fault,match", [
    ("body twice", "bodies ran 201 times"),
    ("no body", "bodies ran 199 times"),
    ("wrong body", r"window's algos say"),
    ("cursor short", "write cursor advanced by 199"),
    ("lat_map short", "lat_map counted 199"),
])
def test_a_window_the_device_did_not_run_fails(smoke, fault, match):
    """A replay whose switch ran a body twice or none, ran another
    algo's body, or whose decision left the cursor or lat_map one short
    fails, whatever the trace saw."""
    before = _counts()
    delta = [ALGOS.count(i) for i in range(4)]
    kw = {}
    if fault == "body twice":
        delta[2] += 1
    elif fault == "no body":
        delta[0] -= 1
    elif fault == "wrong body":
        delta[0], delta[1] = delta[0] - 1, delta[1] + 1
    elif fault == "cursor short":
        kw["cursor"] = N - 1
    else:
        kw["decisions"] = N - 1
    after = _after(before, body_delta=delta, **kw)
    failed, _ = smoke.window_failures(before, after, ALGOS, SEEN)
    assert failed and any(re.search(match, f) for f in failed)


@pytest.mark.parametrize("seen", [
    SEEN,
    # a torchc window that lost whole replays (C12: 196 setters of 200)
    {"kernel": None, "switch": 196, "copies": 380, "nccl": 0},
    # a cuda window that lost a few copy records
    {"kernel": N, "switch": N, "copies": 385, "nccl": 0},
    # nothing at all
    {"kernel": 0, "switch": 0, "copies": 0, "nccl": 0},
])
def test_the_trace_counts_decide_nothing(smoke, seen):
    """Whatever the trace's record counts are, counts that advance by
    the window pass; the line shows what the trace saw."""
    before = _counts()
    failed, line = smoke.window_failures(before, _after(before), ALGOS, seen)
    assert failed == []
    assert f"switch {seen['switch']}" in line
    assert ("kernel" in line) == (seen["kernel"] is not None)


def test_an_output_that_is_an_input_moves_no_bytes(smoke):
    """Without a residual, fused RMSNorm's stream is x: the bound counts
    x read and y written, 2 bytes each a bf16 element; with one, x and r
    read and y and res written."""
    T, D = 64, 256
    x = torch.zeros(1, T, D, dtype=torch.bfloat16)
    scale = torch.ones(D)
    p = {"T": T, "D": D, "residual": False}
    b = smoke.model_bound("fused_rmsnorm", p, [x.reshape(T, D), scale],
                          (torch.empty_like(x), x))
    assert b["bytes"] == 2 * T * D * 2 + 4 * D
    r = torch.zeros_like(x)
    b = smoke.model_bound("fused_rmsnorm", dict(p, residual=True),
                          [x.reshape(T, D), scale, r.reshape(T, D)],
                          (torch.empty_like(x), torch.empty_like(x)))
    assert b["bytes"] == 4 * T * D * 2 + 4 * D


def test_l2_cold_takes_turns_and_keeps_each_output(smoke):
    """Phase 10 times fused RMSNorm over input sets in turn; each call's
    output lives until its next turn, so no call writes where the one
    before it just wrote."""
    made = []

    def maker(i):
        def call():
            made.append(i)
            return torch.empty(4)
        return call
    call = smoke.l2_cold([maker(i) for i in range(3)])
    outs = [call() for _ in range(7)]
    assert made == [0, 1, 2, 0, 1, 2, 0]
    assert len({o.data_ptr() for o in outs[:3]}) == 3


@pytest.mark.parametrize("shared", [False, True])
def test_the_bound_counts_each_storage_once(smoke, shared):
    """A residual that is a view of x's storage is read once; one of its
    own is read as well."""
    T, D = 16, 128
    x = torch.zeros(T, D, dtype=torch.bfloat16)
    r = x.view(T, D) if shared else torch.zeros_like(x)
    scale = torch.ones(D)
    b = smoke.model_bound("fused_rmsnorm", {"T": T, "D": D,
                                            "residual": True},
                          [x, scale, r], (torch.empty_like(x),
                                          torch.empty_like(x)))
    assert b["bytes"] == (3 if shared else 4) * T * D * 2 + 4 * D
