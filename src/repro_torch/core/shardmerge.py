"""Deterministic shard merge — mesh-scale telemetry map reconciliation.

On a multi-device mesh every shard (one per device, or one per rank in a
multi-process launch) executes the same verified policy against its OWN
copy of the map state: in-graph selectors thread a per-rank state
dict, the host bridge keeps one device-resident copy
per shard.  Bringing that state home used to mean picking one shard and
silently dropping the rest.  This module is the reconciliation step: a
**versioned, conflict-free merge** that is bit-deterministic regardless
of shard count and shard arrival order.

Port of the reference's ``core/shardmerge.py`` (numpy only, no torch):
the merge runs on host images of the shard states, so every tier —
the CUDA kernels and their plain PyTorch versions alike — hands it
``uint64`` arrays.  The pair form (``int32[..., 2]`` holding ``[lo,
hi]``) has the bytes of a little-endian ``u64`` array, so
:func:`pairs_to_u64` is a view.

The contract (README "Mesh-scale collectives"):

  * every shard carries a **write cursor** per map — how many kernel
    calls wrote the map on that shard since the shard was seeded;
  * every value slot merges by the reduce named in its
    :class:`~repro.core.program.MapDecl.merge` spec:

      - ``"sum"`` (default, the counter/histogram idiom) — the merged
        cell is ``base + Σ_shards (shard_cell - shard_base_cell)``,
        wrapping u64 addition.  Addition is commutative, so the result
        cannot depend on shard order, and concurrent host mutations of
        ``base`` are never lost: each shard contributes only its own
        delta against the snapshot it was seeded from.
      - ``"max"`` (the EMA / last-writer idiom) — among the shards that
        CHANGED the cell, the one with the highest write cursor wins;
        ties break to the lowest shard id.  Cells no shard changed keep
        the base value.

  * hash maps merge **per key** (each shard's open-addressing layout is
    decoded first, so two shards that inserted the same keys in
    different orders still merge identically); the merged table is
    re-encoded canonically — surviving base keys in base order, then
    new keys sorted — so the merged device array is itself
    bit-deterministic.  Overflow beyond ``max_entries`` drops the
    LAST keys of that canonical order (the E2BIG analogue) and counts
    them in the stats dict.

Supported kinds: the array family (``array`` / ``percpu_array`` /
``perdev_array`` — the device protocol exposes one shard-shaped array
each) and ``hash``.  ``ringbuf`` and ``lru_hash`` carry cursor/recency
control state that has no order-free merge; multi-shard bridges reject
programs that write them.
"""

from __future__ import annotations

from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from .program import MapDecl

U64 = np.uint64

MERGEABLE_KINDS = ("array", "percpu_array", "perdev_array", "hash")


class ShardMergeError(Exception):
    pass


def slot_merge_spec(decl: MapDecl) -> Tuple[str, ...]:
    """The per-u64-slot reduce for ``decl`` — its ``merge`` tuple padded
    with ``"sum"`` to the full slot count."""
    slots = max(1, decl.value_size // 8)
    spec = tuple(getattr(decl, "merge", ()) or ())
    return tuple(spec[i] if i < len(spec) else "sum" for i in range(slots))


def pairs_to_u64(arr) -> np.ndarray:
    """Fold a pair-form ``(..., 2)`` [lo, hi] array (``uint32`` or
    ``int32`` holding the same bits) into uint64."""
    a = np.ascontiguousarray(np.asarray(arr, dtype="<u4"))
    return (a[..., 0].astype(U64) | (a[..., 1].astype(U64) << U64(32)))


def u64_to_pairs(arr) -> np.ndarray:
    """Split a uint64 array into the pair ``(..., 2)`` [lo, hi] form."""
    a = np.asarray(arr, dtype=U64)
    out = np.empty(a.shape + (2,), dtype="<u4")
    out[..., 0] = (a & U64(0xFFFFFFFF)).astype("<u4")
    out[..., 1] = (a >> U64(32)).astype("<u4")
    return out


class Shard:
    """One shard's contribution to a merge.

    ``sid`` is the stable shard identity (device/rank index) — the merge
    sorts on it internally, which is what makes the result independent
    of the order shards are handed in.  ``base`` is the state THIS shard
    was seeded from (shards seeded at different host versions merge
    correctly because each delta is taken against its own base);
    ``cursor`` is the shard's write count for this map.
    """

    __slots__ = ("sid", "arr", "cursor", "base")

    def __init__(self, sid: int, arr, cursor: int, base):
        self.sid = int(sid)
        self.arr = np.asarray(arr, dtype=U64)
        self.cursor = int(cursor)
        self.base = np.asarray(base, dtype=U64)


def _ordered(shards: Iterable[Shard]) -> List[Shard]:
    out = sorted(shards, key=lambda s: s.sid)
    for a, b in zip(out, out[1:]):
        if a.sid == b.sid:
            raise ShardMergeError(f"duplicate shard id {a.sid}")
    return out


def merge_array_shards(decl: MapDecl, base, shards: Sequence[Shard]
                       ) -> np.ndarray:
    """Merge array-family device arrays (``(max_entries, slots)`` u64).

    ``base`` is the CURRENT host state (which may have advanced past any
    shard's seed — host mutations survive the merge untouched)."""
    base = np.asarray(base, dtype=U64)
    out = base.copy()
    spec = slot_merge_spec(decl)
    ordered = _ordered(shards)
    for col, mode in enumerate(spec):
        if mode == "sum":
            acc = base[:, col].copy()
            for s in ordered:
                acc = acc + (s.arr[:, col] - s.base[:, col])  # wraps mod 2^64
            out[:, col] = acc
        else:  # max-version-wins among shards that changed the cell
            val = base[:, col].copy()
            best = np.full(base.shape[0], -1, dtype=np.int64)
            for s in ordered:
                changed = s.arr[:, col] != s.base[:, col]
                take = changed & (s.cursor > best)
                val = np.where(take, s.arr[:, col], val)
                best = np.where(take, s.cursor, best)
            out[:, col] = val
    return out


# ---------------------------------------------------------------------------
# hash maps: decode the open-addressing layout, merge per key, re-encode
# ---------------------------------------------------------------------------

def _decode_hash(decl: MapDecl, arr) -> Dict[int, np.ndarray]:
    """Device hash rows ``[values..., key, used]`` -> {key: value_slots}.

    Iteration is in ROW order, which for a canonically-packed table is
    insertion order — preserved so re-encoding keeps base keys stable."""
    a = np.asarray(arr, dtype=U64)
    slots = max(1, decl.value_size // 8)
    out: Dict[int, np.ndarray] = {}
    for i in range(decl.max_entries):
        if int(a[i, slots + 1]) != 0:
            out[int(a[i, slots])] = a[i, :slots].copy()
    return out


def _encode_hash(decl: MapDecl, table: Dict[int, np.ndarray]) -> np.ndarray:
    """Canonical re-encode: each key at its home slot then linear-probed,
    inserted in the dict's iteration order (see :func:`merge_hash_shards`
    for why that order is deterministic)."""
    from .maps import device_shape, hash_slot
    rows, cols = device_shape(decl.kind, decl.value_size, decl.max_entries)
    slots = cols - 2
    cap = decl.max_entries
    arr = np.zeros((rows, cols), dtype=U64)
    for k, val in table.items():
        i = hash_slot(k, cap)
        while arr[i, slots + 1] != 0:
            i = (i + 1) % cap
        arr[i, :slots] = val
        arr[i, slots] = k
        arr[i, slots + 1] = 1
    arr[cap, 0] = len(table)
    return arr


def merge_hash_shards(decl: MapDecl, base, shards: Sequence[Shard],
                      stats: Optional[dict] = None) -> np.ndarray:
    """Merge hash-map device arrays per KEY.

    A key's slots merge exactly like array cells: counters sum each
    shard's delta against that shard's base (a key the shard inserted
    has an implicit all-zero base), EMA cells go to the writing shard
    with the highest cursor.  In-graph execution is insert/update-only,
    so a key present in any base is never deleted by a shard.

    The merged table is re-encoded with base keys first (base row
    order), then new keys sorted numerically — canonical, so the output
    array is identical for any shard arrival order.  Keys beyond
    ``max_entries`` are dropped from the END of that order (E2BIG) and
    counted in ``stats["dropped_keys"]``."""
    spec = slot_merge_spec(decl)
    nslots = len(spec)
    base_tab = _decode_hash(decl, base)
    ordered = _ordered(shards)
    decoded = [(s, _decode_hash(decl, s.arr), _decode_hash(decl, s.base))
               for s in ordered]

    new_keys = set()
    for _, tab, _ in decoded:
        new_keys.update(tab)
    new_keys -= set(base_tab)
    keys = list(base_tab) + sorted(new_keys)

    zero = np.zeros(nslots, dtype=U64)
    merged: Dict[int, np.ndarray] = {}
    for k in keys:
        bv = base_tab.get(k, zero)
        writers = []
        for s, tab, sbase in decoded:
            sv = tab.get(k)
            if sv is None:
                continue
            sb = sbase.get(k, zero)
            if not np.array_equal(sv, sb):
                writers.append((s, sv, sb))
        if not writers:
            merged[k] = bv.copy()
            continue
        val = np.empty(nslots, dtype=U64)
        for col, mode in enumerate(spec):
            if mode == "sum":
                acc = bv[col]
                for s, sv, sb in writers:
                    acc = U64(acc + (sv[col] - sb[col]))
                val[col] = acc
            else:
                best_cur, cell = -1, bv[col]
                for s, sv, sb in writers:
                    if sv[col] != sb[col] and s.cursor > best_cur:
                        best_cur, cell = s.cursor, sv[col]
                val[col] = cell
        merged[k] = val

    dropped = max(0, len(merged) - decl.max_entries)
    if dropped:
        for k in keys[decl.max_entries:]:
            merged.pop(k, None)
    if stats is not None:
        stats["dropped_keys"] = stats.get("dropped_keys", 0) + dropped
    return _encode_hash(decl, merged)


def merge_map_shards(decl: MapDecl, base, shards: Sequence[Shard],
                     stats: Optional[dict] = None) -> np.ndarray:
    """Kind dispatch: merge one map's shard arrays against ``base``."""
    if decl.kind not in MERGEABLE_KINDS:
        raise ShardMergeError(
            f"map {decl.name!r} (kind {decl.kind}) has no order-free shard "
            f"merge; mergeable kinds: {', '.join(MERGEABLE_KINDS)}")
    if decl.kind == "hash":
        return merge_hash_shards(decl, base, shards, stats)
    return merge_array_shards(decl, base, shards)
