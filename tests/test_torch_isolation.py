"""The port stands alone: ``repro_torch`` imports neither JAX nor the
reference package, and its copies of the policies compile to the
reference's bytecode.

Equality with the reference is held by tests, not by shared code: every
shipped policy (and the §5.2 unsafe suite) must produce the same
instructions, subprograms and map declarations in both packages.
"""

import ast
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import pytest

import repro.policies as ref_policies
import repro.policies.profiler as ref_profiler
from repro_torch.policies import ALL_POLICIES, UNSAFE_PROGRAMS

PKG = Path(__file__).resolve().parents[1] / "src" / "repro_torch"
MODULES = ["repro_torch", "repro_torch.device", "repro_torch.core",
           "repro_torch.core.torchc", "repro_torch.core.cudac",
           "repro_torch.core.bridge", "repro_torch.core.runtime",
           "repro_torch.core.pair", "repro_torch.core.shardmerge",
           "repro_torch.core.jit", "repro_torch.core.cc", "repro_torch.obs",
           "repro_torch.obs.recorder", "repro_torch.obs.exporter",
           "repro_torch.policies", "repro_torch.collectives",
           "repro_torch.collectives.dispatch",
           "repro_torch.collectives.algorithms",
           "repro_torch.collectives.ingraph", "repro_torch.launch",
           "repro_torch.launch.mesh", "repro_torch.kernels",
           "repro_torch.kernels._build",
           "repro_torch.kernels.rmsnorm.ref",
           "repro_torch.kernels.rmsnorm.kernel",
           "repro_torch.kernels.rmsnorm.ops",
           "repro_torch.kernels.grouped_matmul.ref",
           "repro_torch.kernels.grouped_matmul.kernel",
           "repro_torch.kernels.grouped_matmul.ops",
           "repro_torch.kernels.flash_attention.ref",
           "repro_torch.kernels.flash_attention.kernel",
           "repro_torch.kernels.flash_attention.ops",
           "repro_torch.configs", "repro_torch.models",
           "repro_torch.models.config", "repro_torch.models.layers",
           "repro_torch.models.attention", "repro_torch.models.mlp",
           "repro_torch.models.moe", "repro_torch.models.recurrent",
           "repro_torch.models.transformer", "repro_torch.models.convert",
           "repro_torch.models.lm", "repro_torch.serve",
           "repro_torch.serve.engine", "repro_torch.data",
           "repro_torch.data.pipeline", "repro_torch.train",
           "repro_torch.train.schedule", "repro_torch.train.optimizer",
           "repro_torch.train.checkpoint", "repro_torch.train.step",
           "repro_torch.train.trainer", "repro_torch.launch.train",
           "repro_torch.launch.specs", "repro_torch.launch.roofline",
           "repro_torch.launch.dryrun"]
EXAMPLES = PKG.parents[1] / "examples"
# the port's examples: imported (each runs only under __main__) and scanned
EXAMPLE_MODULES = ["quickstart_torch", "policy_authoring_torch",
                   "serve_adaptive_torch", "train_lm_torch"]


def test_import_pulls_in_no_jax_and_no_reference_module():
    code = ("import importlib, json, sys\n"
            f"for m in {MODULES + EXAMPLE_MODULES!r}:\n"
            "    importlib.import_module(m)\n"
            "print(json.dumps(sorted(m for m in sys.modules if m == 'jax' "
            "or m.startswith('jax.') or m == 'repro' "
            "or m.startswith('repro.'))))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([str(PKG.parent), str(EXAMPLES)])
    r = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, env=env, timeout=120)
    assert r.returncode == 0, r.stderr
    assert json.loads(r.stdout.strip().splitlines()[-1]) == []


def _imports(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


def test_no_source_file_names_jax_or_the_reference():
    bad = []
    paths = sorted(PKG.rglob("*.py")) + [EXAMPLES / f"{m}.py"
                                         for m in EXAMPLE_MODULES] \
        + [PKG.parents[1] / "chip_smoke.py"]
    for path in paths:
        for mod in _imports(path):
            top = mod.split(".")[0]
            if top in ("jax", "jaxlib", "repro"):
                bad.append(f"{path.name}: {mod}")
    assert not bad, bad


def _shape(prog):
    """Everything the verifier and the tiers read off a program."""
    return (prog.name, prog.section,
            [dataclasses.astuple(i) for i in prog.insns],
            [(sp.name, sp.n_args, [dataclasses.astuple(i)
                                   for i in sp.insns])
             for sp in prog.subprogs],
            [dataclasses.astuple(d) for d in prog.maps])


@pytest.mark.parametrize("pol", ALL_POLICIES, ids=lambda p: p.program.name)
def test_policy_bytecode_equals_reference(pol):
    name = pol.program.name
    ref = getattr(ref_policies, name, getattr(ref_profiler, name, None))
    assert ref is not None, name
    assert _shape(pol.program) == _shape(ref.program)


@pytest.mark.parametrize("bug", sorted(UNSAFE_PROGRAMS))
def test_unsafe_suite_equals_reference(bug):
    prog, frag = UNSAFE_PROGRAMS[bug]
    ref_prog, ref_frag = ref_policies.UNSAFE_PROGRAMS[bug]
    assert frag == ref_frag
    assert _shape(prog) == _shape(ref_prog)
