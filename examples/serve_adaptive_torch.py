"""Batched serving with the profiler->tuner closed loop, on the PyTorch port.

    PYTHONPATH=src python examples/serve_adaptive_torch.py          # the card
    PYTHONPATH=src python examples/serve_adaptive_torch.py --cpu    # CPU

Serves a small model with continuous batching while the profiler program
streams each engine tick's latency into a shared map and the adaptive
tuner reads it for its channel decision — the paper's §5.3 loop, attached
to a real serving engine (``examples/serve_adaptive.py`` on the JAX
package).  The policies run on the CUDA policy kernel (``tier="cuda"``)
unless ``--cpu`` asks for their plain PyTorch version (``tier="torch"``).

The feeds and the decision go through the dispatcher
(``profiler_feed`` / ``decide``), so the profiler writes the map slot of
the communicator the tuner decides for (``adapt_map`` is keyed by
communicator id).
"""

import argparse
import time

from repro_torch.collectives.dispatch import _comm_id, reset_dispatcher
from repro_torch.configs import get_smoke_config
from repro_torch.core.context import CollType
from repro_torch.core.runtime import PolicyRuntime
from repro_torch.models import init_params
from repro_torch.models.layers import MeshAxes
from repro_torch.policies import adapt_profiler, adapt_tuner
from repro_torch.serve import ServeConfig, ServeEngine

AX = MeshAxes(tp=1, dp=1, fsdp=False)
# the collective the tuner decides for: a 1 MiB all-reduce over 8 ranks
AXIS, N_RANKS, MSG = "tp", 8, 1 << 20


def attach_loop(tier: str):
    """A runtime on ``tier`` with the profiler and tuner loaded, and the
    process-wide dispatcher over it."""
    rt = PolicyRuntime(tier=tier)
    rt.load(adapt_profiler.program)
    rt.load(adapt_tuner.program)
    return rt, reset_dispatcher(runtime=rt)


def feed(disp, latency_ns: int) -> None:
    """One tick's latency into the profiler (the tuner's communicator)."""
    disp.profiler_feed(_comm_id(AXIS, N_RANKS), latency_ns,
                       coll=CollType.ALL_REDUCE, msg_size=MSG)


def decide(disp):
    """The tuner's decision for the loop's collective."""
    return disp.decide(CollType.ALL_REDUCE, MSG, N_RANKS, axis_name=AXIS)


def serve(eng, disp) -> list:
    """Tick ``eng`` until drained, feeding each tick's latency (host clock
    around the tick, which ends in a read of the next tokens) to the
    profiler.  Returns the latencies in ns."""
    lat = []
    while eng.queue or eng.active:
        t0 = time.perf_counter_ns()
        eng.step()
        lat.append(time.perf_counter_ns() - t0)
        feed(disp, lat[-1])
    return lat


def samples(rt) -> int:
    """Profiler samples counted in the tuner's map slot."""
    return rt.maps.get("adapt_map").lookup_u64(
        _comm_id(AXIS, N_RANKS) % 64, 2)


def main(device=None, tier: str = "cuda") -> dict:
    rt, disp = attach_loop(tier)

    cfg = get_smoke_config("tinyllama-1.1b")
    params, _ = init_params(0, cfg, AX, device=device)
    eng = ServeEngine(cfg, params, AX,
                      ServeConfig(batch_slots=4, max_ctx=96), device=device)

    reqs = [eng.submit(list(range(3 + i % 5)), max_new=12)
            for i in range(16)]
    t0 = time.perf_counter()
    lat = serve(eng, disp)
    wall = time.perf_counter() - t0

    done = sum(r.done for r in reqs)
    req_lat = [r.done_at - r.submitted_at for r in reqs if r.done]
    d = decide(disp)
    print(f"served {done}/{len(reqs)} requests in {wall:.2f}s "
          f"({len(lat)} engine ticks on {eng.device})")
    print(f"mean request latency {sum(req_lat) / len(req_lat) * 1e3:.0f} ms")
    print(f"adaptive tuner's live channel decision: {d.channels} "
          f"(from {samples(rt)} profiler samples, tier {tier})")
    print(f"sample outputs: {[r.out for r in reqs[:2]]}")
    return {"served": done, "requests": len(reqs), "ticks": len(lat),
            "samples": samples(rt), "decision": d}


if __name__ == "__main__":
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="serve on the CPU with the policies' plain "
                         "PyTorch version (tier torch)")
    args = ap.parse_args()
    if args.cpu:
        main(device="cpu", tier="torch")
    else:
        main()
