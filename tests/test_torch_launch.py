"""The port's launch plane against the reference's: ``launch/specs.py``,
``launch/roofline.py``'s predictors, ``train/step.py::make_serve_step``
and ``launch/dryrun.py``.

- Specs: for every arch and shape, on the ``MeshAxes`` of the (16, 16)
  and (2, 16, 16) meshes (built directly, no mesh), the params, optimizer
  state, batch and caches equal the reference's leaf by leaf: shape,
  dtype and spec.
- Predictors: ``predict_allreduce_time``, ``best_allreduce_algo`` and
  ``model_flops`` equal the reference's exactly over a sweep, and the
  mirrors of ``tests/test_mesh_dispatch.py``'s predictor tests run on
  the port's predictor and ``topo_tuner``.
- ``make_serve_step``: prefill logits, decode tokens and the final caches
  within 1e-5 of the reference's in f32 on the dense, MoE and recurrent
  smoke configs (relative to the largest magnitude of the reference's
  tensor; tokens exact): on one device in this process, and at ``tp = 2``
  on two ``gloo`` ranks against the reference on a 2-device host mesh in
  a child (``tests/torch_launch_check.py``).
- The dry run: on a fake 4-rank (2, 2) group at the smoke configs, train,
  prefill and decode run (``status: ok``), the matmul FLOPs per rank
  within 5% of the reference's dot FLOPs (its compiled step's HLO through
  ``parse_hlo`` + ``multiplicities`` + ``aggregate``, in the child) and
  the collective kinds equal; full-width tinyllama-1.1b ``train_4k`` on
  the 256- and 512-rank fake groups through the command line; and
  without ``--device cpu`` on a machine with no card it stops with
  ``DeviceError``.

``repro.launch.dryrun`` is never imported here: it writes ``XLA_FLAGS``
when imported.
"""

import functools
import json
import multiprocessing as mp
import os
import socket
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

import repro.launch.roofline as ref_roof
import repro.launch.specs as ref_specs
from repro.configs import get_config as ref_get_config
from repro.configs import serving_config as ref_serving_config
from repro.core.context import Algo, CollType
from repro.models.layers import MeshAxes as RefAxes

import torch_launch_check as chk
from repro_torch.collectives.dispatch import reset_dispatcher
from repro_torch.configs import SHAPES, get_smoke_config, serving_config
from repro_torch.configs.registry import ARCH_IDS
from repro_torch.core import PolicyRuntime, make_ctx
from repro_torch.device import DeviceError, have_cuda
from repro_torch.launch import dryrun, roofline, specs
from repro_torch.models.layers import MeshAxes
from repro_torch.models.transformer import tree_leaves
from repro_torch.policies.mesh import topo_tuner
from repro_torch.train.step import spec_leaves

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
KiB, MiB = 1 << 10, 1 << 20
SERVE_TOL = 1e-5
FLOPS_TOL = 0.05


def _axes(cls, mesh: str, fsdp: bool):
    pod = mesh == "2pod"
    return cls(data="data", model="model", pod="pod" if pod else None,
               fsdp=fsdp, tp=16, dp=16, n_pods=2 if pod else 1)


# ---------------------------------------------------------------------------
# specs
# ---------------------------------------------------------------------------

def _ref_leaves(tree, spec_tree) -> list:
    flat = jax.tree.leaves(tree)
    flat_s = jax.tree.leaves(spec_tree, is_leaf=lambda v: isinstance(v, P))
    assert len(flat) == len(flat_s)
    return [(tuple(a.shape), str(a.dtype), tuple(s))
            for a, s in zip(flat, flat_s)]


def _port_leaves(tree, spec_tree) -> list:
    flat = tree_leaves(tree)
    flat_s = spec_leaves(spec_tree)
    assert len(flat) == len(flat_s)
    for a in flat:
        assert a.device.type == "meta"
    return [(tuple(a.shape), str(a.dtype).replace("torch.", ""), tuple(s))
            for a, s in zip(flat, flat_s)]


def _is_ref(tree) -> bool:
    return isinstance(jax.tree.leaves(tree)[0], jax.ShapeDtypeStruct)


@functools.lru_cache(maxsize=None)
def _ref_params(arch: str, shape: str, mesh: str, fsdp: bool):
    cfg = ref_serving_config(arch, shape)
    sds, sp = ref_specs.param_shapes_and_specs(cfg, _axes(RefAxes, mesh,
                                                          fsdp))
    return sds, sp, ref_specs.opt_shapes(sds)


@functools.lru_cache(maxsize=None)
def _port_params(arch: str, shape: str, mesh: str, fsdp: bool):
    cfg = serving_config(arch, shape)
    params, sp = specs.param_shapes_and_specs(cfg, _axes(MeshAxes, mesh,
                                                         fsdp))
    return params, sp, specs.opt_shapes(params)


def _leaf_table(tree) -> list:
    return [(tuple(a.shape), str(a.dtype).replace("torch.", ""))
            for a in (jax.tree.leaves(tree) if _is_ref(tree)
                      else tree_leaves(tree))]


@pytest.mark.parametrize("mesh", ["pod", "2pod"])
@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_specs_equal_the_reference_leaf_by_leaf(arch, shape, mesh):
    sh = SHAPES[shape]
    fsdp = sh.kind == "train"
    r_p, r_s, r_o = _ref_params(arch, shape, mesh, fsdp)
    p_p, p_s, p_o = _port_params(arch, shape, mesh, fsdp)
    assert _port_leaves(p_p, p_s) == _ref_leaves(r_p, r_s)
    assert _leaf_table(p_o) == _leaf_table(r_o)

    cfg, rcfg = serving_config(arch, shape), ref_serving_config(arch, shape)
    B, S = sh.global_batch, sh.seq_len
    for kind in ("train", "prefill"):
        got = specs.batch_shapes(cfg, B, S, kind=kind)
        want = ref_specs.batch_shapes(rcfg, B, S, kind=kind)
        assert sorted(got) == sorted(want)
        assert _leaf_table(got) == _leaf_table(want)

    ax, rax = _axes(MeshAxes, mesh, fsdp), _axes(RefAxes, mesh, fsdp)
    world_dp = 16 * rax.n_pods
    replicate = B < world_dp or B % world_dp != 0
    dp_axes = None if replicate else (
        ("pod", "data") if rax.pod else "data")
    got = specs.cache_shapes_and_specs(cfg, B, S, ax, dp_axes)
    want = ref_specs.cache_shapes_and_specs(rcfg, B, S, rax, dp_axes)
    assert _port_leaves(*got) == _ref_leaves(*want)


# ---------------------------------------------------------------------------
# the predictors
# ---------------------------------------------------------------------------

SWEEP_SIZES = [1, 4 * KiB, 64 * KiB, 1 * MiB, 32 * MiB, 1 << 30]
SWEEP_RANKS = [2, 3, 8, 16, 256, 512]


@pytest.mark.parametrize("n_nodes", [1, 2, 4])
def test_predictors_equal_the_reference(n_nodes):
    for size in SWEEP_SIZES:
        for n in SWEEP_RANKS:
            for algo in roofline.ALLREDUCE_ALGOS:
                assert roofline.predict_allreduce_time(
                    algo, size, n, n_nodes=n_nodes) == \
                    ref_roof.predict_allreduce_time(algo, size, n,
                                                    n_nodes=n_nodes)
            assert roofline.best_allreduce_algo(size, n, n_nodes=n_nodes) \
                == ref_roof.best_allreduce_algo(size, n, n_nodes=n_nodes)
    assert roofline.ALLREDUCE_ALGOS == ref_roof.ALLREDUCE_ALGOS
    with pytest.raises(ValueError, match="unknown allreduce algo"):
        roofline.predict_allreduce_time("nvls", MiB, 8)


def test_predictor_defaults_are_the_fitted_ones_and_the_roofline_the_h100s():
    """The predictor keeps the parameters topo_tuner was fitted to; the
    roofline's own terms are the H100 SXM datasheet's."""
    assert roofline.FITTED_LINK_BW == ref_roof.LINK_BW
    assert roofline.LINK_LATENCY_S == ref_roof.LINK_LATENCY_S
    assert roofline.INTER_NODE_PENALTY == ref_roof.INTER_NODE_PENALTY
    assert roofline.TREE_BW_DERATE == ref_roof.TREE_BW_DERATE
    assert (roofline.PEAK_FLOPS, roofline.HBM_BW, roofline.LINK_BW,
            roofline.N_LINKS) == (989e12, 3.35e12, 25e9, 18)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_model_flops_equals_the_reference(arch):
    cfg, rcfg = serving_config(arch, "train_4k"), ref_get_config(arch)
    for kind, b, s in (("train", 256, 4096), ("prefill", 32, 32768),
                       ("decode", 128, 32768), ("decode", 1, 524288)):
        assert roofline.model_flops(cfg, kind, b, s) == \
            ref_roof.model_flops(rcfg, kind, b, s)


def test_topo_tuner_matches_alpha_beta_predictor():
    """The mirror of tests/test_mesh_dispatch.py's: the port's topo_tuner
    thresholds agree with the port's predictor argmin across sizes x node
    counts (within 1.3x at crossovers)."""
    rt = PolicyRuntime(tier="jit")
    rt.load(topo_tuner.program)
    algo_name = {Algo.RING: "ring", Algo.TREE: "tree",
                 Algo.BIDIR_RING: "bidir_ring"}
    sizes = [16 * KiB, 64 * KiB, 256 * KiB, 1 * MiB, 4 * MiB, 32 * MiB]
    for n_nodes, rpn in [(1, 8), (2, 2), (2, 4), (2, 8), (4, 4), (4, 8)]:
        n_ranks = n_nodes * rpn
        for size in sizes:
            ctx = make_ctx("tuner", coll_type=CollType.ALL_REDUCE,
                           msg_size=size, n_ranks=n_ranks, max_channels=16,
                           n_nodes=n_nodes, ranks_per_node=rpn)
            assert rt.invoke("tuner", ctx) == 1
            got = algo_name[ctx["algorithm"]]
            want = roofline.best_allreduce_algo(size, n_ranks,
                                                n_nodes=n_nodes)
            if got != want:
                t_got = roofline.predict_allreduce_time(
                    got, size, n_ranks, n_nodes=n_nodes)
                t_best = roofline.predict_allreduce_time(
                    want, size, n_ranks, n_nodes=n_nodes)
                assert t_got <= 1.3 * t_best, (
                    f"size={size} nodes={n_nodes}: policy {got} is "
                    f"{t_got / t_best:.2f}x the predictor's {want}")


def test_predictor_shape_sanity():
    assert set(roofline.ALLREDUCE_ALGOS) == {"ring", "tree", "bidir_ring"}
    # single-node degenerate 2D == ring + constant
    assert roofline.predict_allreduce_time("bidir_ring", 1 * MiB, 8) >= \
        roofline.predict_allreduce_time("ring", 1 * MiB, 8)
    # latency regime favors tree, bandwidth regime favors ring
    assert roofline.best_allreduce_algo(4 * KiB, 8) == "tree"
    assert roofline.best_allreduce_algo(32 * MiB, 8) == "ring"


def test_wire_bytes_formulas_are_the_reference_ones():
    for g in (2, 4, 16):
        s = 3 * 1024.0
        assert roofline.wire_bytes("all-reduce", g, s) == 2 * (g - 1) / g * s
        assert roofline.wire_bytes("all-gather", g, s) == (g - 1) / g * s
        assert roofline.wire_bytes("reduce-scatter", g, s) == (g - 1) * s
        assert roofline.wire_bytes("all-to-all", g, s) == (g - 1) / g * s
        assert roofline.wire_bytes("collective-permute", g, s) == s


def test_trace_analyzer_counts_a_matmul_and_frees_its_temps():
    an = roofline.TraceAnalyzer()
    a = torch.empty((64, 32), device="meta")
    b = torch.empty((32, 16), device="meta")
    an.arguments((a, b))
    with an:
        t = a @ b            # 2 * 64 * 16 * 32 FLOPs, a temp of 4 KiB
        y = (t * 2.0).sum(0)
        del t
    an.outputs(y)
    assert an.flops == 2 * 64 * 16 * 32
    assert an.arg_bytes == (64 * 32 + 32 * 16) * 4
    # the product, its double and the sum live together at the peak; each
    # temp is freed when its last reference goes
    assert an.peak_bytes == 2 * 64 * 16 * 4 + 16 * 4
    assert an.live_bytes == 16 * 4
    mem = an.memory_analysis()
    assert mem["output_size_in_bytes"] == 16 * 4
    assert "generated_code_size_in_bytes" not in mem


def test_tree_flatten_holds_no_leaf_past_its_last_reference():
    """C9: a flattened tree's leaves die with their last reference, not
    at the next cyclic collection (the dry run's working set found 20 GiB
    of a train step's gradients and AdamW trees held that way)."""
    import gc
    import weakref

    from repro_torch.models.transformer import tree_flatten
    gc.disable()
    try:
        t = torch.ones(4)
        dead = weakref.ref(t)
        leaves, rebuild = tree_flatten({"a": [t, torch.zeros(2)], "b": (t,)})
        rebuild(leaves)
        del t, leaves, rebuild
        assert dead() is None
    finally:
        gc.enable()


def test_a_train_step_leaves_no_tensor_in_a_reference_cycle():
    import gc

    from repro_torch.data import DataConfig
    from repro_torch.train import Trainer, TrainerConfig, TrainStepConfig

    reset_dispatcher(tier="jit")
    cfg = get_smoke_config("tinyllama-1.1b").with_overrides(remat=True)
    tr = Trainer(cfg, MeshAxes(), None, TrainerConfig(
        steps=2, log_every=10 ** 9, data=DataConfig(seq_len=16,
                                                    global_batch=2),
        step=TrainStepConfig(total_steps=4, warmup_steps=1)), device="cpu")
    tr.run(steps=1)
    gc.collect()
    gc.disable()
    gc.set_debug(gc.DEBUG_SAVEALL)
    try:
        tr.run(steps=1)
        gc.collect()
        held = [o for o in gc.garbage if isinstance(o, torch.Tensor)]
    finally:
        gc.set_debug(0)
        gc.garbage.clear()
        gc.enable()
    assert held == []


# ---------------------------------------------------------------------------
# make_serve_step
# ---------------------------------------------------------------------------

def _held(got: dict, want: dict) -> None:
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        g = got[k]
        assert g.shape == w.shape and g.dtype == w.dtype, k
        if k.startswith("token/"):
            np.testing.assert_array_equal(g, w, err_msg=k)
            continue
        w64 = np.asarray(w, np.float64)
        scale = max(float(np.max(np.abs(w64))), 1e-30)
        err = float(np.max(np.abs(np.asarray(g, np.float64) - w64)))
        assert err <= SERVE_TOL * scale, f"{k}: {err / scale:.3g} of max"


@pytest.mark.parametrize("arch", chk.SERVE_ARCHS)
def test_serve_step_one_device_equals_reference(arch):
    from repro.collectives.dispatch import reset_dispatcher as ref_reset
    from repro.core.runtime import PolicyRuntime as RefRuntime

    ref_reset(runtime=RefRuntime())
    reset_dispatcher(tier="jit")
    want = chk.reference_serve(arch, 1, jax.devices())
    _, w = chk.reference_weights(arch, 1)
    got = chk.port_serve(arch, w, MeshAxes(), get_smoke_config(arch)
                         .with_overrides(dtype="float32"))
    _held(got, want)


def test_serve_step_rejects_an_unknown_mode():
    cfg = get_smoke_config("tinyllama-1.1b")
    _, sp = specs.param_shapes_and_specs(cfg, MeshAxes())
    from repro_torch.train.step import make_serve_step
    with pytest.raises(ValueError, match="prefill' or 'decode"):
        make_serve_step(cfg, MeshAxes(), None, sp, None, mode="train")


# ---------------------------------------------------------------------------
# the mesh runs: the reference child, 2 gloo ranks, the fake groups
# ---------------------------------------------------------------------------

def _port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _dry_jobs() -> list:
    return [dict(arch=a, shape_name=s, multi_pod=False, tier="jit",
                 mesh_shape=(2, 2), cfg=get_smoke_config(a),
                 global_batch=b, seq_len=q)
            for a, s, b, q in chk.DRY_COMBOS]


def _cli_full_width(out_dir: str) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(REPO, "src")
    return subprocess.run(
        [sys.executable, "-W", "ignore", "-m", "repro_torch.launch.dryrun",
         "--arch", "tinyllama-1.1b", "--shape", "train_4k", "--mesh",
         "both", "--device", "cpu", "--out", out_dir],
        env=env, capture_output=True, text=True, timeout=600)


class _Runs:
    """Everything that runs in other processes, started together when the
    module's first test starts: the reference child, the 2 gloo ranks at
    tp = 2, the (2, 2) fake group and the full-width command line."""

    def __init__(self, tmp):
        self.tmp = tmp
        self.collected = False
        env = dict(os.environ)
        env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
        env["JAX_PLATFORMS"] = "cpu"
        env["PYTHONPATH"] = os.pathsep.join(
            [os.path.join(REPO, "src"), os.path.join(REPO, "tests")])
        self.ref = subprocess.Popen(
            [sys.executable,
             os.path.join(REPO, "tests", "torch_launch_check.py"),
             str(tmp / "reference")], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True)
        self.pool = ThreadPoolExecutor(max_workers=2)
        self.dry = self.pool.submit(dryrun.run_mesh, 4, _dry_jobs(), 600)
        self.cli = self.pool.submit(_cli_full_width, str(tmp / "full"))
        jobs = [(a, chk.reference_weights(a, 2)[1])
                for a in chk.SERVE_ARCHS]
        ctx = mp.get_context("spawn")
        self.q = ctx.Queue()
        port = _port()
        self.procs = [ctx.Process(target=chk.rank_main,
                                  args=(r, 2, port, self.q, jobs))
                      for r in range(2)]
        for p in self.procs:
            p.start()

    def close(self) -> None:
        for p in self.procs:
            # collected ranks exit at once; uncollected ones (a run of a
            # few tests) would wait on their queue's unread results
            p.join(timeout=30 if self.collected else 0)
            if p.is_alive():
                p.terminate()
                p.join()
        if self.ref.poll() is None:
            self.ref.kill()
        self.pool.shutdown()

    def collect(self) -> dict:
        tmp = self.tmp
        self.collected = True
        try:
            ranks = dict(self.q.get(timeout=600) for _ in self.procs)
            _, err = self.ref.communicate(timeout=600)
            dry_res, cli_res = self.dry.result(), self.cli.result()
        finally:
            self.close()
        for r, rec in ranks.items():
            assert "error" not in rec, f"rank {r}:\n{rec['error']}"
        assert self.ref.returncode == 0, err[-3000:]
        with open(tmp / "reference.json") as f:
            ref_dry = json.load(f)
        full = {}
        for name in os.listdir(tmp / "full"):
            with open(tmp / "full" / name) as f:
                r = json.load(f)
            full[r["mesh"]] = r
        return {"ranks": ranks, "ref": dict(np.load(tmp / "reference.npz")),
                "ref_dry": ref_dry, "dry": dry_res, "cli": cli_res,
                "full": full}


@pytest.fixture(scope="module", autouse=True)
def _started(tmp_path_factory):
    started = _Runs(tmp_path_factory.mktemp("launch"))
    yield started
    started.close()


@pytest.fixture(scope="module")
def runs(_started):
    return _started.collect()


@pytest.mark.parametrize("arch", chk.SERVE_ARCHS)
def test_serve_step_tp2_equals_reference(runs, arch):
    want = {k[len(arch) + 1:]: v for k, v in runs["ref"].items()
            if k.startswith(arch + "/")}
    for r in (0, 1):
        _held(runs["ranks"][r][arch], want)


@pytest.mark.parametrize("combo", [f"{a}|{s}" for a, s, _, _
                                   in chk.DRY_COMBOS])
def test_dry_run_on_a_fake_2x2_group_matches_the_reference(runs, combo):
    i = [f"{a}|{s}" for a, s, _, _ in chk.DRY_COMBOS].index(combo)
    got, want = runs["dry"][i], runs["ref_dry"][combo]
    assert got["status"] == "ok", got.get("traceback", got)
    assert got["mesh"] == "2x2" and got["n_devices"] == 4
    rel = abs(got["trace_flops_per_dev"] - want["flops"]) / want["flops"]
    assert rel <= FLOPS_TOL, (got["trace_flops_per_dev"], want["flops"])
    assert sorted(got["collectives_by_op"]) == sorted(want["by_op"])
    mem = got["memory_analysis"]
    assert mem["argument_size_in_bytes"] > 0 and mem["temp_size_in_bytes"] > 0


def test_full_width_dry_run_on_256_and_512_fake_ranks(runs):
    cli = runs["cli"]
    assert cli.returncode == 0, cli.stdout[-2000:] + cli.stderr[-2000:]
    assert "DONE 2 combos, 0 errors" in cli.stdout
    full = runs["full"]
    assert sorted(full) == ["2pod", "pod"]
    for mesh, n in (("pod", 256), ("2pod", 512)):
        r = full[mesh]
        assert r["status"] == "ok" and r["n_devices"] == n
        assert r["collective_wire_bytes_per_dev"] > 0
        assert r["decisions"]["made"] > 0
        assert r["dominant"] in ("compute", "memory", "collective")
    # the 2-pod mesh halves each rank's batch and so its FLOPs
    ratio = full["pod"]["trace_flops_per_dev"] / \
        full["2pod"]["trace_flops_per_dev"]
    assert 1.9 < ratio < 2.1


@pytest.mark.skipif(have_cuda(), reason="checks the machine without a card")
def test_dry_run_without_device_cpu_needs_the_card(capsys):
    with pytest.raises(DeviceError):
        dryrun.main(["--arch", "tinyllama-1.1b", "--shape", "train_4k"])
    assert "===" not in capsys.readouterr().out
