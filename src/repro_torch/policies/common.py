"""Shared policy subroutines — the bpf-to-bpf call library.

Module-level ``@subroutine`` functions that any policy (any section) can
call; the frontend compiles each into a callee subprogram of the calling
policy, the verifier checks the call graph (no recursion, depth <= 8,
per-frame stack accounting), and every tier executes the calls:

  * host tiers (interp / jit v1+v2 / native) run real calls with a fresh
    512-byte frame per callee;
  * in-graph tiers (jaxc / pallas / pallas32) inline the callee bodies at
    lowering time, so the traced graph is call-free and retrace-count
    stays zero.

Subroutine ABI (mirrors the kernel's): up to 5 scalar args in r1..r5,
scalar result in r0, r6-r9 callee-saved, no ctx access inside callees.

``log2_bucket`` and ``ema_step`` are the helpers the telemetry tuner and
profiler share (:mod:`repro_torch.policies.telemetry`) — one definition, two
hook sections, per the paper's composable-policy-library claim.
"""

from __future__ import annotations

from ..core.frontend import subroutine


@subroutine
def log2_bucket(x):
    """floor(log2(x)) for x >= 1 (0 for x in {0, 1}) — branchless-ish
    shift cascade, 6 compares for the full u64 range."""
    b = 0
    if x >> 32:
        b += 32
        x >>= 32
    if x >> 16:
        b += 16
        x >>= 16
    if x >> 8:
        b += 8
        x >>= 8
    if x >> 4:
        b += 4
        x >>= 4
    if x >> 2:
        b += 2
        x >>= 2
    if x >> 1:
        b += 1
    return b


@subroutine
def ema_step(old, sample, shift):
    """One exponential-moving-average step with weight w = 2**shift:
    new = (old*(w-1) + sample) / w, computed as shifts so the verifier
    never sees a division by an unknown callee argument (shifts are
    trap-free for any operand; a div's divisor interval would have to
    exclude 0, which an opaque r3 can't)."""
    w = 1 << shift
    return (old * (w - 1) + sample) >> shift


@subroutine
def clamp(x, lo, hi):
    """x clamped into [lo, hi]."""
    if x < lo:
        return lo
    if x > hi:
        return hi
    return x


@subroutine
def bucket_key(coll, size):
    """Composite hash key for per-(collective, size-bucket) telemetry:
    coll in the high byte, log2 size bucket in the low byte.  A
    subroutine calling a subroutine — exercises call depth 2 on every
    tier."""
    b = log2_bucket(size)
    return (coll << 8) | b


SUBROUTINES = [log2_bucket, ema_step, clamp, bucket_key]
