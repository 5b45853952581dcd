"""The general part of a run: find a cell's files by name, check the chips,
hand the cell to its runner, read the per-layer metrics, check isolation,
and print the result line.

A run prints, as its last lines on standard error, every number that
decides ``correct`` beside its limit, and as its last line on standard
output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device`` (and ``breakdown`` with ``--trace 1``), with the
compared numbers last, under ``compared``.
"""

from __future__ import annotations

import argparse
import dataclasses
import importlib
import importlib.util
import json
import os
import sys
from pathlib import Path
from typing import Any, Callable, Dict, List, Optional

PKG = Path(__file__).resolve().parent
ROOT = PKG.parent

# top-level module names a run may not hold once its window has closed:
# JAX and the JAX package the port was made from (compared whole: the
# port's own name, ``repro_torch``, begins with ``repro``)
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


class RunError(RuntimeError):
    """A run that cannot produce a result (no card, a missing file, a
    module it may not load)."""


@dataclasses.dataclass
class Compared:
    """One number that decides ``correct``, beside its limit."""
    name: str
    value: float
    limit: float

    @property
    def ok(self) -> bool:
        return self.value <= self.limit


@dataclasses.dataclass
class Cell:
    """A workload of ``BENCHMARK.json`` with its files read."""
    name: str
    chips: int
    config_name: str
    config: dict
    traffic_name: str
    mix: dict
    model: Optional[dict]
    bench: dict


@dataclasses.dataclass
class Outcome:
    """What a runner hands back: the end-to-end numbers it timed, the
    observations the per-layer readers take their numbers from, and the
    comparison with the plain reference."""
    attempted: int
    failed: int
    end_to_end: Dict[str, float]
    obs: Dict[str, Any]
    compared: List[Compared]
    device: Dict[str, Any]
    breakdown: Optional[dict] = None


def load_bench(root: Path = ROOT) -> dict:
    path = root / "BENCHMARK.json"
    if not path.is_file():
        raise RunError(f"no BENCHMARK.json in {root}")
    return json.loads(path.read_text())


def _json(path: Path) -> dict:
    if not path.is_file():
        raise RunError(f"missing {path}")
    return json.loads(path.read_text())


def find_cell(bench: dict, name: str, root: Path = ROOT) -> Cell:
    """The workload ``name`` with its configuration (the file its entry
    names), its mix (``portbench/mixes/<traffic>.json``) and the mix's
    model (``portbench/models/<model>.json``), under ``root``."""
    work = {w["name"]: w for w in bench["workloads"]}
    if name not in work:
        raise RunError(f"no workload {name!r}; have {sorted(work)}")
    w = work[name]
    confs = {c["name"]: c for c in bench["configs"]}
    pkg = root / PKG.name
    conf = _json(root / confs[w["config"]]["file"])
    mix = _json(pkg / "mixes" / f"{w['traffic']}.json")
    model = _json(pkg / "models" / f"{mix['model']}.json") \
        if "model" in mix else None
    return Cell(name=name, chips=int(w["chips"]), config_name=w["config"],
                config=conf, traffic_name=w["traffic"], mix=mix,
                model=model, bench=bench)


def runner(kind: str):
    """The general runner that runs every mix of ``kind``."""
    if not (PKG / "runners" / f"{kind}.py").is_file():
        raise RunError(f"no runner for mix kind {kind!r}")
    return importlib.import_module(f"portbench.runners.{kind}")


def cell_metrics(bench: dict, cell: str) -> List[dict]:
    """The per-layer metrics ``cell`` reports: those that list it, and
    those without a list whose moved end-to-end metric it reports."""
    e2e = {m["name"] for m in cell_metrics_e2e(bench, cell)}
    return [m for m in bench["per_layer"]
            if (cell in m["workloads"] if "workloads" in m
                else m["moves"] in e2e)]


def cell_metrics_e2e(bench: dict, cell: str) -> List[dict]:
    return [m for m in bench["end_to_end"]
            if "workloads" not in m or cell in m["workloads"]]


def reader(name: str, pkg: Path = PKG) -> Callable[[dict], Optional[float]]:
    """The ``read(obs)`` function of ``metrics/<name>.py``."""
    path = pkg / "metrics" / f"{name}.py"
    if not path.is_file():
        raise RunError(f"no reader metrics/{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"portbench.metrics.{name.replace('.', '_').replace('-', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def forbidden_modules(names) -> List[str]:
    """The loaded modules whose top-level name, taken whole, is JAX's or
    the JAX package's."""
    return sorted(n for n in names if n.split(".", 1)[0] in FORBIDDEN)


def check_isolation() -> None:
    bad = forbidden_modules(list(sys.modules))
    if bad:
        raise RunError("the run loaded modules it may not: " + ", ".join(bad))


def require_chips(n: int) -> None:
    """Fail unless torch sees ``n`` CUDA cards or more."""
    import torch
    if not torch.cuda.is_available():
        raise RunError("torch sees no CUDA device")
    if torch.cuda.device_count() < n:
        raise RunError(f"the cell needs {n} cards, torch sees "
                       f"{torch.cuda.device_count()}")


def result(cell: Cell, out: Outcome, trace: bool) -> dict:
    """The result line's object.  The end-to-end numbers with
    ``--trace 0``, the per-layer readers' numbers with ``--trace 1`` (a
    reader that finds nothing returns None and its metric is left out)."""
    metrics = {}
    if trace:
        for m in cell_metrics(cell.bench, cell.name):
            v = reader(m["name"])(out.obs)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in cell_metrics_e2e(cell.bench, cell.name):
            if m["name"] not in out.end_to_end:
                raise RunError(f"the runner gave no {m['name']}")
            metrics[m["name"]] = {"value": out.end_to_end[m["name"]],
                                  "unit": m["unit"]}
    line = {"correct": all(c.ok for c in out.compared) and
            bool(out.compared),
            "attempted": out.attempted, "failed": out.failed,
            "metrics": metrics, "device": out.device}
    if trace and out.breakdown is not None:
        line["breakdown"] = out.breakdown
    line["compared"] = {c.name: {"value": c.value, "limit": c.limit}
                        for c in out.compared}
    return line


def emit(line: dict) -> None:
    for name, c in line["compared"].items():
        print(f"compared {name}: {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)


@dataclasses.dataclass
class RunArgs:
    workload: str
    seed: int
    seconds: float
    trace: bool
    t_start: float                 # the process's start, host clock
    device: str = "cuda"           # "cpu" only in the harness's own tests
    tier: Optional[str] = None     # the configuration's tier unless set
    sizes: Optional[dict] = None   # smaller sizes for the CPU tests
    fault: Optional[str] = None    # a fault planted by the CPU tests


def run(args: RunArgs, bench: Optional[dict] = None) -> dict:
    """Run one cell once and return its result line's object."""
    bench = bench if bench is not None else load_bench()
    cell = find_cell(bench, args.workload)
    if importlib.util.find_spec("repro_torch") is None:
        raise RunError("the port's package repro_torch is not beside the "
                       "harness (src/repro_torch)")
    if args.device == "cuda":
        require_chips(cell.chips)
    from . import faults
    with faults.planted(args.fault):
        out = runner(cell.mix["kind"]).run(cell, args)
    return result(cell, out, args.trace)


def parse(argv) -> argparse.Namespace:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv, t_start: float) -> int:
    a = parse(argv)
    try:
        line = run(RunArgs(a.workload, a.seed, a.seconds, bool(a.trace),
                           t_start))
        check_isolation()
    except RunError as e:
        print(f"portbench: {e}", file=sys.stderr)
        return 2
    emit(line)
    return 0


def cache_dirs(root: Path = ROOT) -> None:
    """Keep every build and kernel cache inside the checkout, at fixed
    paths (the port's nvcc outputs already go to ``build/``)."""
    for var, sub in (("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TRITON_CACHE_DIR", "triton"),
                     ("CUDA_CACHE_PATH", "cuda_cache")):
        os.environ[var] = str(root / "build" / "portbench" / sub)
