"""Policy zoo: Table 1 suite, §5.2 unsafe suite, §5.3 case studies."""

from .casestudies import (adapt_map, adapt_profiler, adapt_tuner,
                          bad_channels, env_defaults, net_accounting,
                          net_stats, ring_mid_v2)
from .loops import (LOOP_POLICIES, histogram_bucket_tuner,
                    latency_argmin_tuner)
from .mesh import topo_tuner
from .profiler import latency_histogram, straggler_trap
from .perf import (expert_chunked_a2a, grad_compress,
                   grad_compress_bidir, tpu_size_aware)
from .table1 import (SAFE_POLICIES, adaptive_channels, bandwidth_probe,
                     latency_feedback, native_baseline, noop, size_aware,
                     slo_enforcer, static_override)
from .telemetry import TELEMETRY_POLICIES, bucket_profiler, bucket_tuner
from .unsafe import UNSAFE_PROGRAMS

# every shipped policy program (the §5.2 unsafe suite aside), in a fixed
# order: the set every tier and the policy kernel are held equal on
ALL_POLICIES = (
    noop, static_override, size_aware, adaptive_channels, latency_feedback,
    bandwidth_probe, slo_enforcer, ring_mid_v2, bad_channels,
    adapt_profiler, adapt_tuner, net_accounting, env_defaults,
    latency_argmin_tuner, histogram_bucket_tuner, topo_tuner,
    expert_chunked_a2a, grad_compress, grad_compress_bidir, tpu_size_aware,
    bucket_tuner, bucket_profiler, latency_histogram, straggler_trap,
)

__all__ = [
    "ALL_POLICIES",
    "LOOP_POLICIES", "SAFE_POLICIES", "TELEMETRY_POLICIES",
    "UNSAFE_PROGRAMS", "bucket_profiler", "bucket_tuner",
    "adaptive_channels", "histogram_bucket_tuner", "latency_argmin_tuner",
    "adapt_map", "adapt_profiler", "adapt_tuner", "bad_channels",
    "bandwidth_probe", "env_defaults", "latency_feedback", "native_baseline",
    "net_accounting", "net_stats", "noop", "ring_mid_v2", "size_aware",
    "expert_chunked_a2a", "grad_compress", "grad_compress_bidir",
    "tpu_size_aware",
    "slo_enforcer", "static_override", "topo_tuner",
]
