"""The seven unsafe programs of §5.2 — one per bug class, all hand-assembled
(bypassing the frontend, which would refuse to emit most of them).

Each MUST be rejected by the verifier at load time with an actionable
message.  ``UNSAFE_PROGRAMS`` maps bug-class name -> (program, expected
message fragment).
"""

from __future__ import annotations

from ..core.asm import assemble
from ..core.frontend import map_decl

_lat = map_decl("latency_map", kind="hash", key_size=4, value_size=16,
                max_entries=256)

# 1. null-pointer dereference: use the lookup result without a NULL check.
null_deref = assemble("""
    ldxdw  r2, [r1+comm_id]
    stxw   [r10-8], r2
    ldmap  r1, latency_map
    mov64  r2, r10
    add64i r2, -8
    call   map_lookup_elem
    ldxdw  r3, [r0+0]          ; BUG: r0 may be NULL here
    exit
""", name="null_deref", section="tuner", maps=(_lat,))

# 2. out-of-bounds access: read past the end of the ctx struct.
oob_ctx = assemble("""
    ldxdw  r2, [r1+2048]       ; BUG: ctx is 88 bytes
    mov64  r0, 0
    exit
""", name="oob_ctx", section="tuner")

# 3. illegal helper: trace_printk is not whitelisted for tuner programs.
illegal_helper = assemble("""
    mov64  r1, 42
    call   trace_printk        ; BUG: profiler-only helper
    mov64  r0, 0
    exit
""", name="illegal_helper", section="tuner")

# 4. stack overflow: write below the 512-byte frame.
stack_overflow = assemble("""
    mov64  r2, 7
    stxdw  [r10-520], r2       ; BUG: beyond the frame
    mov64  r0, 0
    exit
""", name="stack_overflow", section="tuner")

# 5. unbounded loop: a back edge the verifier cannot bound.
unbounded_loop = assemble("""
    mov64  r2, 0
loop:
    add64i r2, 1
    jlt    r2, r2, done        ; never true -> spins forever
    ja     loop
done:
    mov64  r0, 0
    exit
""", name="unbounded_loop", section="tuner")

# 6. input-field write: tuner must not modify its inputs.
input_write = assemble("""
    mov64  r2, 0
    stxdw  [r1+msg_size], r2   ; BUG: msg_size is read-only
    mov64  r0, 0
    exit
""", name="input_write", section="tuner")

# 7. division by zero: divisor interval contains zero (comes from ctx).
div_by_zero = assemble("""
    ldxdw  r2, [r1+msg_size]
    ldxdw  r3, [r1+n_ranks]
    div64  r2, r3              ; BUG: n_ranks not proven nonzero
    mov64  r0, 0
    exit
""", name="div_by_zero", section="tuner")

UNSAFE_PROGRAMS = {
    "null_deref": (null_deref, "map_value_or_null"),
    "oob_ctx": (oob_ctx, "out-of-bounds ctx access"),
    "illegal_helper": (illegal_helper, "illegal helper"),
    "stack_overflow": (stack_overflow, "stack access out of bounds"),
    "unbounded_loop": (unbounded_loop, "back-edge"),
    "input_write": (input_write, "read-only input field"),
    "div_by_zero": (div_by_zero, "contains 0"),
}
