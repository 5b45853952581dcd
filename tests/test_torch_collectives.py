"""The port's collective algorithms over ``torch.distributed``, on an
8-rank ``gloo`` group, against torch's own collectives and against the
reference's outputs on the same inputs.

One spawn per file: a module fixture starts the reference half of
``tests/torch_collective_check.py`` (the JAX package on an 8-device host
mesh, in a subprocess with ``XLA_FLAGS`` set in its environment only)
and, beside it, 8 spawned ranks running the port's half; the tests read
their outputs.

Tolerances: rtol = atol = 1e-5 where the wire is full precision
(SIMPLE), 2e-2 where a bf16 wire was chosen (LL, LL128).  Against torch's
own collective the bf16 cases use the small-integer payload, which a
bf16 wire carries exactly; against the reference, which runs the same
algorithm, every case uses the random normal payload.
"""

import multiprocessing as mp
import os
import socket
import subprocess
import sys

import numpy as np
import pytest

import torch_collective_check as chk

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CASES = chk.cases()


def _tol(kw) -> float:
    return 1e-5 if kw.get("protocol", chk.SIMPLE) == chk.SIMPLE else 2e-2


def _port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """(reference outputs, {rank: port outputs})."""
    out = tmp_path_factory.mktemp("coll") / "reference.npz"
    env = dict(os.environ)
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.join(REPO, "src"), os.path.join(REPO, "tests")])
    ref = subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests",
                                      "torch_collective_check.py"),
         str(out)], env=env, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, text=True)
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = _port()
    procs = [ctx.Process(target=chk.rank_main, args=(r, port, q))
             for r in range(chk.N)]
    for p in procs:
        p.start()
    try:
        ranks = dict(q.get(timeout=300) for _ in range(chk.N))
        _, err = ref.communicate(timeout=300)
    finally:
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.terminate()
        if ref.poll() is None:
            ref.kill()
    for r, rec in ranks.items():
        assert "error" not in rec, f"rank {r}:\n{rec['error']}"
    assert ref.returncode == 0, err[-3000:]
    return dict(np.load(out)), ranks


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_algorithm_matches_torch_collective(runs, case):
    name, _, _, _, kw = case
    _, ranks = runs
    tol = _tol(kw)
    for r, rec in ranks.items():
        np.testing.assert_allclose(rec[f"{name}/int"],
                                   rec[f"{name}/int/native"],
                                   rtol=tol, atol=tol, err_msg=f"rank {r}")
        if tol == 1e-5:
            np.testing.assert_allclose(rec[f"{name}/normal"],
                                       rec[f"{name}/normal/native"],
                                       rtol=tol, atol=tol,
                                       err_msg=f"rank {r}")


@pytest.mark.parametrize("case", CASES, ids=lambda c: c[0])
def test_algorithm_matches_reference(runs, case):
    name, _, _, shape, kw = case
    ref, ranks = runs
    tol = _tol(kw)
    want = ref[name]
    rows = want.shape[0] // chk.N
    for r, rec in ranks.items():
        got = rec[f"{name}/normal"]
        np.testing.assert_allclose(got, want[r * rows:(r + 1) * rows],
                                   rtol=tol, atol=tol, err_msg=f"rank {r}")
        # torch's collective equals the reference's native one
        np.testing.assert_allclose(
            rec[f"{name}/normal/native"],
            ref[f"{name}/native"][r * rows:(r + 1) * rows],
            rtol=1e-5, atol=1e-5, err_msg=f"rank {r}")


def test_subgroup_maps_ranks_and_tree_falls_back_to_ring(runs):
    _, ranks = runs
    for r in range(2, chk.N):
        rec = ranks[r]
        for k in ("sub6/tree", "sub6/ring_c3"):
            np.testing.assert_allclose(rec[k], rec["sub6/native"],
                                       rtol=1e-5, atol=1e-5)
    assert "sub6/tree" not in ranks[0]


def test_policy_driven_dispatch_end_to_end(runs):
    """ring_mid_v2: 2 MiB per rank defers to the default, 8 MiB runs the
    ring on LL128 with 32 channels; a hot reload to bad_channels switches
    to one channel — outputs equal torch's all-reduce throughout."""
    from repro_torch.core.context import Algo, Proto
    _, ranks = runs
    for r, rec in ranks.items():
        small, mid, reload = rec["decisions"]
        assert small[0] == Algo.DEFAULT and not small[3]
        assert mid == (Algo.RING, Proto.LL128, 32, True)
        assert reload[0] == Algo.RING and reload[2] == 1
        for k, tol in (("disp_small", 1e-5), ("disp_mid", 2e-2)):
            np.testing.assert_allclose(rec[k], rec[f"{k}/native"],
                                       rtol=tol, atol=tol)
        np.testing.assert_allclose(rec["disp_reload"], rec["disp_mid/native"],
                                   rtol=2e-2, atol=2e-2)


def test_injected_decide_fault_is_invisible_to_the_collective(runs):
    from repro_torch.core.context import Algo
    _, ranks = runs
    for rec in ranks.values():
        assert rec["fault_identical"]
        assert rec["fault_exceptions"] > 0
        assert rec["fault_decision"] == (Algo.DEFAULT, False)


def test_ingraph_all_reduce_matches_reference(runs):
    ref, ranks = runs
    want_algos = ref["ingraph/algos"].tolist()
    assert want_algos[0] == 0 and want_algos[-1] == 2
    for r, rec in ranks.items():
        assert rec["ingraph/algos"] == want_algos
        assert rec["ingraph/host_syncs"] == len(want_algos)
        np.testing.assert_allclose(rec["ingraph/y"], rec["ingraph/native"],
                                   rtol=1e-5, atol=1e-5)
        np.testing.assert_allclose(rec["ingraph/y"],
                                   ref["ingraph/y"][r:r + 1],
                                   rtol=1e-5, atol=1e-5)


def test_mesh_topology_over_a_device_mesh(runs):
    _, ranks = runs
    for rec in ranks.values():
        assert rec["topology"] == {"n_nodes": 2, "ranks_per_node": 4,
                                   "n_devices": 8,
                                   "axis_sizes": {"node": 2, "local": 4}}
        assert tuple(rec["dispatcher_topology"]) == (2, 4)
