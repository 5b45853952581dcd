"""α-β-γ cost model for collective algorithms — the NCCL cost table analogue.

Two calibrations ship, copied as data from the reference package so
the port's decisions equal the reference's:

* ``TPU_V5E`` — the reference's default profile (the dispatch layer's
  default cost table).  Its constants describe the reference's target,
  not this port's card; an H100 profile measured on the card comes with
  the collectives.
* ``NVLINK_B300`` — the reference's fit to the paper's Table 2 (8× B300,
  NVLink 5, NCCL 2.29.7).

Model per algorithm (t in seconds, S bytes, n ranks, c channels):

  ring:   t = 2(n-1)·(α/c_eff + S/(n·B_ring(c)))
  tree:   t = 2·log2(n)·(α + S/(2·B_tree))        (halving/doubling)
  default:t = α_d + S·(n-1)/n / B_nvls(S)          (switch-offload analogue;
                                                    B rises with S, like NVLS)

Protocols scale α and B: LL halves wire bytes but caps B (fine-grained
flags); Simple is bandwidth-optimal.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict

from ..core.context import Algo, CollType, Proto


@dataclasses.dataclass(frozen=True)
class HwProfile:
    name: str
    alpha_s: float            # per-hop latency (s)
    link_bw: float            # per-link, per-direction bandwidth (B/s)
    n_links: int              # links usable per chip for one collective
    default_alpha_s: float    # launch overhead of the built-in path
    # built-in ("NVLS analogue") effective bus bandwidth by log2(MiB):
    default_bw_table: Dict[int, float] = dataclasses.field(default_factory=dict)
    ll_bw_factor: float = 0.55       # LL wire: latency-optimized, lower bw
    ll_alpha_factor: float = 0.35
    ll128_bw_factor: float = 0.92
    ll128_alpha_factor: float = 0.6
    channel_alpha_discount: float = 0.5  # how much channels hide hop latency
    max_channel_speedup: float = 2.2     # rings saturate links beyond this
    # optional measured ring busbw (Simple, c=32) by log2(MiB): when present
    # the ring model interpolates it instead of the pure alpha-beta form
    ring_bw_table: Dict[int, float] = dataclasses.field(default_factory=dict)


GBs = 1e9

# --- the reference's default profile (data only) ----------------------------
TPU_V5E = HwProfile(
    name="tpu_v5e",
    alpha_s=1.0e-6,
    link_bw=50 * GBs,
    n_links=4,
    default_alpha_s=2.0e-6,
    default_bw_table={0: 30 * GBs, 2: 60 * GBs, 4: 90 * GBs, 6: 120 * GBs,
                      8: 160 * GBs, 10: 180 * GBs, 13: 190 * GBs},
)

# --- 8x B300 NVLink 5 (paper testbed), fit to Table 2 ----------------------
# Table 2 default(NVLS) bus-bw GB/s: 4M:133.5 8M:196.3 16M:278.8 32M:349.3
#   64M:425.2 128M:596.9 256M:656.5 8G:836.3
# Ring fit (c=32, Simple): busbw = 1.75·S / (14α + 1.75·S/B) with
# α = 2.79 µs, B = 690 GB/s reproduces the Ring column within ~6 %
# (residuals reported by benchmarks/table2_allreduce.py).
NVLINK_B300 = HwProfile(
    name="nvlink_b300",
    alpha_s=2.79e-6,
    link_bw=313.6 * GBs,      # per-ring effective; ×2.2 channel sat = 690
    n_links=18,
    default_alpha_s=9.0e-6,
    default_bw_table={2: 133.5 * GBs, 3: 196.3 * GBs, 4: 278.8 * GBs,
                      5: 349.3 * GBs, 6: 425.2 * GBs, 7: 596.9 * GBs,
                      8: 656.5 * GBs, 13: 836.3 * GBs},
    # LL128 on NVLink trades ~5% bandwidth for lower latency
    ll128_bw_factor=0.97,
    ll128_alpha_factor=0.95,
    ll_bw_factor=0.5,
    ll_alpha_factor=0.8,
    ring_bw_table={2: 148.1 * GBs, 3: 249.7 * GBs, 4: 337.4 * GBs,
                   5: 402.4 * GBs, 6: 471.8 * GBs, 7: 628.9 * GBs,
                   8: 632.5 * GBs, 13: 697.6 * GBs},
)


def _interp_log2(table: Dict[int, float], size_bytes: float) -> float:
    ks = sorted(table)
    x = math.log2(max(size_bytes, 1) / (1 << 20))
    if x <= ks[0]:
        return table[ks[0]]
    if x >= ks[-1]:
        return table[ks[-1]]
    for a, b in zip(ks, ks[1:]):
        if a <= x <= b:
            t = (x - a) / (b - a)
            return table[a] * (1 - t) + table[b] * t
    return table[ks[-1]]


class CostModel:
    def __init__(self, hw: HwProfile = TPU_V5E):
        self.hw = hw
        # memoized (coll, size, n, channels) -> immutable cost table; the
        # tuner-v5 translation in the dispatch layer reads these on every
        # decision, and under jit tracing the same shapes recur constantly
        self._table_cache: Dict[tuple, tuple] = {}

    def _proto_factors(self, protocol: int):
        hw = self.hw
        if protocol == Proto.LL:
            return hw.ll_alpha_factor, hw.ll_bw_factor
        if protocol == Proto.LL128:
            return hw.ll128_alpha_factor, hw.ll128_bw_factor
        return 1.0, 1.0

    def _channel_bw(self, c: int) -> float:
        """Rings on multiple channels use more links, saturating."""
        hw = self.hw
        speed = min(1.0 + (c - 1) * 0.12, hw.max_channel_speedup)
        return hw.link_bw * speed

    def time_s(self, coll: int, algo: int, proto: int, channels: int,
               size_bytes: int, n: int) -> float:
        if n <= 1 or size_bytes <= 0:
            return 0.0
        hw = self.hw
        af, bf = self._proto_factors(proto)
        c = max(1, min(channels, 32))
        if algo == Algo.DEFAULT:
            # the bw table IS the measured busbw (launch overhead included)
            bw = _interp_log2(hw.default_bw_table, size_bytes)
            return self._coll_bytes_factor(coll, n) * size_bytes / bw
        alpha = hw.alpha_s * af
        bw = self._channel_bw(c) * bf
        if algo in (Algo.RING, Algo.BIDIR_RING):
            hops = 2 * (n - 1) if coll == CollType.ALL_REDUCE else (n - 1)
            bidir = 2.0 if algo == Algo.BIDIR_RING else 1.0
            if hw.ring_bw_table and coll == CollType.ALL_REDUCE:
                # calibrated: split measured time into alpha + bytes parts,
                # apply protocol/channel factors to each
                busbytes = self._coll_bytes_factor(coll, n) * size_bytes
                bw32 = _interp_log2(hw.ring_bw_table, size_bytes)
                t_meas = busbytes / bw32
                t_alpha = hops * hw.alpha_s
                t_bytes = max(t_meas - t_alpha, 0.05 * t_meas)
                c_scale = self._channel_bw(32) / self._channel_bw(c)
                return t_alpha * af + t_bytes * c_scale / bf / bidir
            per_hop = size_bytes / n / (bw * bidir)
            return hops * (alpha + per_hop)
        if algo == Algo.TREE:
            steps = 2 * math.ceil(math.log2(n))
            # halving/doubling moves S/2 + S/4 + ... ≈ S total per phase
            return steps * alpha + 2.0 * size_bytes / bw / 2.0
        return float("inf")

    def _coll_bytes_factor(self, coll: int, n: int) -> float:
        if coll == CollType.ALL_REDUCE:
            return 2.0 * (n - 1) / n
        if coll in (CollType.ALL_GATHER, CollType.REDUCE_SCATTER):
            return (n - 1) / n
        if coll == CollType.ALL_TO_ALL:
            return (n - 1) / n
        return 1.0

    def bus_bandwidth(self, coll: int, algo: int, proto: int, channels: int,
                      size_bytes: int, n: int) -> float:
        """NCCL-tests style busbw (B/s) — what Table 2 reports."""
        t = self.time_s(coll, algo, proto, channels, size_bytes, n)
        if t <= 0:
            return float("inf")
        return self._coll_bytes_factor(coll, n) * size_bytes / t

    # --- tuner-v5-style cost table ------------------------------------------
    def cost_table_cached(self, coll: int, size_bytes: int, n: int,
                          channels: int = 8) -> tuple:
        """Immutable (n_algos, n_protos) cost rows, memoized per argument
        tuple.  Callers that need to modify costs must copy (or use
        :meth:`cost_table`)."""
        key = (coll, size_bytes, n, channels)
        t = self._table_cache.get(key)
        if t is None:
            if len(self._table_cache) >= 4096:
                self._table_cache.clear()  # bound memory on size sweeps
            t = tuple(
                tuple(self.time_s(coll, a, p, channels, size_bytes, n)
                      for p in range(Proto.COUNT))
                for a in range(Algo.COUNT))
            self._table_cache[key] = t
        return t

    def cost_table(self, coll: int, size_bytes: int, n: int,
                   channels: int = 8):
        """(n_algos, n_protos) float costs — what the dispatch layer hands
        to NCCL-compatible policies that modify cost tables in place."""
        return [list(row)
                for row in self.cost_table_cached(coll, size_bytes, n,
                                                  channels)]
