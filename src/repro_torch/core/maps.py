"""Typed eBPF maps: structured, concurrent cross-plugin state.

This is the composability substrate of the paper (§3, T2): profiler programs
write telemetry, tuner programs read it, through *typed* maps with atomic
access semantics — no ad hoc shared memory, no locking bugs in policy code.

Map kinds (mirroring the kernel):
  * ARRAY   — fixed number of slots, u32 key = index, preallocated values.
  * HASH    — bounded-capacity hash map, fixed-size keys.
  * PERCPU_ARRAY — one array per "cpu" (here: per host thread slot), for
    contention-free counters aggregated on read.
  * RINGBUF — bounded MPSC event stream (the observability plane's
    spine): programs ``reserve``/``submit`` fixed-size records, host
    consumers ``drain()`` them FIFO; a full ring drops the NEW record
    and counts it (``drops``).  Cursors are free-running u64s, so the
    same state machine lowers to the in-graph tiers with the control
    words appended to the value array (see :func:`device_shape`).
  * PERDEV_ARRAY — one array shard per device index with a host-side
    merge view; the in-graph tiers see the *current* shard, so the
    lowering is exactly the array lowering.
  * LRU_HASH — fixed-capacity hash with clock/LRU eviction: ``update``
    on a full map evicts the least-recently-used entry instead of
    failing, and every lookup/update refreshes the entry's recency.

Keys and values are fixed-size byte strings; the verifier checks that policy
programs pass correctly-sized stack buffers.  Host-side code uses the typed
``lookup_u64``/``update_u64`` convenience accessors.

Concurrency — the mutation contract:

  * ``lookup()`` (and the typed host accessors built on it) **copies the
    value out under the per-map lock**: cross-thread callers get a
    consistent snapshot that can never tear mid-``update()`` and whose
    mutation cannot alias map storage.
  * ``lookup_ref()`` returns the **live** backing bytearray — the
    kernel-eBPF "pointer to the value slot".  Only the execution tiers
    (VM / JIT) use it; direct pointer stores through it are tear-free
    per 8-byte slot (GIL + single slice assignment), matching the kernel
    model where racing element writes are allowed per-slot.
  * every multi-slot **writeback path holds the per-map lock** —
    ``update()``, ``update_u64()``, and the tiers' read-modify-write
    helpers (``ema_update``) — so host readers can never observe a
    half-applied multi-slot value or lose an update to an unlocked RMW.
  * host code composing its own read-modify-write transactions takes
    :attr:`BpfMap.lock` explicitly (an RLock, so the typed accessors
    nest inside it).
"""

from __future__ import annotations

import ctypes
import struct
import threading
from typing import Dict, Iterator, List, Optional

import numpy as np

U64 = (1 << 64) - 1


def device_shape(kind: str, value_size: int, max_entries: int) -> tuple:
    """uint64 device-array shape ``(rows, cols)`` for one map.

    The in-graph tiers (jaxc / pallas / pallas32) carry every map as one
    dense uint64 array; kinds with cursor/recency state append it to the
    same array so the kernel harness and the bridge stay kind-agnostic:

      * array-family — ``(max_entries, value_size // 8)``
      * ringbuf — record rows plus control rows holding the four control
        words ``head, tail, drops, pending`` (packed ``value_size // 8``
        words per row)
      * hash — fixed-capacity open-addressing table: each row is
        ``[values..., key, used]`` (linear probing over
        ``(key_lo ^ key_hi) % max_entries``, tombstone-free) and one
        trailing control row holds the occupancy counter
      * lru_hash — each row is ``[values..., key, recency]`` and one
        trailing control row holds the clock

    The verifier bounds map-value pointers to ``value_size``, so policy
    code can never reach the appended control state."""
    slots = max(1, value_size // 8)
    if kind == "ringbuf":
        ctl_rows = -(-4 // slots)           # ceil(4 / slots)
        return (max_entries + ctl_rows, slots)
    if kind in ("hash", "lru_hash"):
        return (max_entries + 1, slots + 2)
    return (max_entries, slots)


def hash_slot(key: int, max_entries: int) -> int:
    """Home slot of ``key`` in the open-addressing device table.

    Folding the halves keeps the modulus in 32 bits, so the pair-form
    (lo, hi) lowering computes the identical slot with ONE uint32 mod:
    ``(key_lo ^ key_hi) % max_entries``."""
    return ((key & 0xFFFFFFFF) ^ (key >> 32)) % max_entries


class MapError(Exception):
    pass


class BpfMap:
    """Base class.  Values live in one backing bytearray per element."""

    kind = "base"

    def __init__(self, name: str, key_size: int, value_size: int, max_entries: int):
        if key_size <= 0 or value_size <= 0 or max_entries <= 0:
            raise MapError(f"map {name}: sizes must be positive")
        self.name = name
        self.key_size = key_size
        self.value_size = value_size
        self.max_entries = max_entries
        # reentrant: typed accessors (update_u64) compose lookup+update
        # under one critical section
        self._lock = threading.RLock()
        # monotone content-version counter: bumped by every mutation on
        # the structured surface (update / update_u64 / delete), by the
        # execution tiers' helper writebacks, AND by the runtime tiers'
        # store instructions through map-value pointers (the VM tags the
        # pointer with its owning map; the v2 JIT emits a touch at every
        # verified map store; the legacy v1 JIT touches through its
        # region table's owner column).  Device-resident bridge caches
        # (pallasc.DeviceBridge) key their uploads off it, so a clean
        # map never round-trips.  NOT tracked: host code writing through
        # raw lookup_ref views; such writers call touch() /
        # bridge.invalidate() explicitly.
        self._version = 0
        # native-tier mutation counter: compiled code bumps this cell with
        # one machine increment at call exit (per dirty map) instead of
        # calling back into Python.  ``version`` reads the sum, so bridge
        # caches observe native mutations exactly like touch()ed ones.
        self._native_bumps = (ctypes.c_uint64 * 1)(0)

    @property
    def lock(self) -> threading.RLock:
        """The per-map mutex every writeback path holds; host callers
        composing their own read-modify-write transactions take it too."""
        return self._lock

    @property
    def version(self) -> int:
        """Content version — changes iff the map was mutated through the
        tracked surface since last observed."""
        return self._version + self._native_bumps[0]

    def touch(self) -> None:
        """Mark the map contents changed (for mutations done through raw
        ``lookup_ref`` pointers that the tracked surface cannot see)."""
        with self._lock:
            self._version += 1

    def native_view(self) -> "NativeMapView":
        """Stable C-ABI view for the native tier (array family only);
        other kinds route through Python helper handlers."""
        raise MapError(
            f"map {self.name} (kind {self.kind}) has no native view")

    # -- raw interface -----------------------------------------------------
    def lookup(self, key: bytes) -> Optional[bytearray]:
        """Copy-out lookup for cross-thread (host-side) callers.

        The copy is taken under the map lock, so it can never tear
        against a lock-held writeback, and mutating it cannot alias map
        storage.  Execution tiers use :meth:`lookup_ref` for kernel-style
        pointer semantics."""
        with self._lock:
            v = self.lookup_ref(key)
            return None if v is None else bytearray(v)

    def lookup_ref(self, key: bytes) -> Optional[bytearray]:
        """Live view of the value cell (the eBPF value pointer) — VM/JIT
        tiers only.  Single-slot stores through it are GIL-atomic;
        multi-slot writebacks must hold :attr:`lock`."""
        raise NotImplementedError

    def update(self, key: bytes, value: bytes) -> int:
        raise NotImplementedError

    def delete(self, key: bytes) -> int:
        raise NotImplementedError

    def keys(self) -> Iterator[bytes]:
        raise NotImplementedError

    def _check_key(self, key: bytes) -> None:
        if len(key) != self.key_size:
            raise MapError(
                f"map {self.name}: key size {len(key)} != {self.key_size}")

    def _check_value(self, value: bytes) -> None:
        if len(value) != self.value_size:
            raise MapError(
                f"map {self.name}: value size {len(value)} != {self.value_size}")

    # -- typed convenience (host side) -------------------------------------
    def lookup_u64(self, key: int, slot: int = 0) -> Optional[int]:
        v = self.lookup(struct.pack("<I", key) if self.key_size == 4
                        else struct.pack("<Q", key))
        if v is None:
            return None
        return struct.unpack_from("<Q", v, slot * 8)[0]

    def update_u64(self, key: int, value: int, slot: int = 0) -> None:
        kb = struct.pack("<I", key) if self.key_size == 4 else struct.pack("<Q", key)
        # lock-held writeback through the live view (lookup_ref, not the
        # copy-out lookup: pack_into on a copy would silently drop the
        # write)
        with self._lock:
            v = self.lookup_ref(kb)
            if v is None:
                buf = bytearray(self.value_size)
                struct.pack_into("<Q", buf, slot * 8, value & U64)
                self.update(kb, bytes(buf))
            else:
                struct.pack_into("<Q", v, slot * 8, value & U64)
                self._version += 1

    def snapshot(self) -> Dict[bytes, bytes]:
        with self._lock:
            return {bytes(k): bytes(self.lookup_ref(k))
                    for k in list(self.keys())}

    # -- in-graph device protocol ------------------------------------------
    # The jaxc/pallas tiers move map state as dense uint64 arrays shaped
    # by device_shape(); each kind packs/unpacks its own layout so the
    # bridge and the kernel harness never branch on map kind.
    def device_shape(self) -> tuple:
        return device_shape(self.kind, self.value_size, self.max_entries)

    def to_device(self) -> "np.ndarray":
        raise MapError(f"map {self.name} (kind {self.kind}) has no "
                       "in-graph device representation")

    def from_device(self, arr) -> None:
        raise MapError(f"map {self.name} (kind {self.kind}) has no "
                       "in-graph device representation")


class ArrayMap(BpfMap):
    kind = "array"

    def __init__(self, name: str, value_size: int, max_entries: int):
        super().__init__(name, 4, value_size, max_entries)
        self._slots = [bytearray(value_size) for _ in range(max_entries)]

    def _live_slots(self) -> List[bytearray]:
        """The slot list the execution tiers (and the device protocol)
        see — subclasses with sharded storage override this."""
        return self._slots

    def to_device(self) -> np.ndarray:
        with self._lock:
            flat = b"".join(bytes(s) for s in self._live_slots())
        return np.frombuffer(flat, dtype="<u8").reshape(
            self.max_entries, self.value_size // 8).copy()

    def from_device(self, arr) -> None:
        data = np.ascontiguousarray(np.asarray(arr, dtype="<u8")).tobytes()
        vs = self.value_size
        with self._lock:
            for i, s in enumerate(self._live_slots()):
                s[:] = data[i * vs:(i + 1) * vs]
            self._version += 1

    def _index(self, key: bytes) -> Optional[int]:
        self._check_key(key)
        idx = struct.unpack("<I", key)[0]
        return idx if idx < self.max_entries else None

    def native_view(self) -> "NativeMapView":
        with self._lock:
            v = getattr(self, "_native_view", None)
            if v is None:
                v = self._native_view = NativeMapView(self)
            return v

    def lookup_ref(self, key: bytes) -> Optional[bytearray]:
        idx = self._index(key)
        return None if idx is None else self._slots[idx]

    def update(self, key: bytes, value: bytes) -> int:
        self._check_value(value)
        idx = self._index(key)
        if idx is None:
            return -1
        with self._lock:
            self._slots[idx][:] = value
            self._version += 1
        return 0

    def delete(self, key: bytes) -> int:
        # Array maps cannot delete (kernel semantics: -EINVAL).
        return -1

    def keys(self) -> Iterator[bytes]:
        for i in range(self.max_entries):
            yield struct.pack("<I", i)


class HashMap(BpfMap):
    kind = "hash"

    def __init__(self, name: str, key_size: int, value_size: int, max_entries: int):
        super().__init__(name, key_size, value_size, max_entries)
        self._table: Dict[bytes, bytearray] = {}

    def lookup_ref(self, key: bytes) -> Optional[bytearray]:
        self._check_key(key)
        return self._table.get(bytes(key))

    def update(self, key: bytes, value: bytes) -> int:
        self._check_key(key)
        self._check_value(value)
        kb = bytes(key)
        with self._lock:
            if kb not in self._table and len(self._table) >= self.max_entries:
                return -1  # E2BIG
            slot = self._table.setdefault(kb, bytearray(self.value_size))
            slot[:] = value
            self._version += 1
        return 0

    def delete(self, key: bytes) -> int:
        self._check_key(key)
        with self._lock:
            if self._table.pop(bytes(key), None) is None:
                return -1
            self._version += 1
            return 0

    def keys(self) -> Iterator[bytes]:
        return iter(list(self._table.keys()))

    def __len__(self) -> int:
        with self._lock:
            return len(self._table)

    # -- in-graph device protocol ------------------------------------------
    # Open-addressing table: max_entries rows of [values..., key, used]
    # plus a control row holding the occupancy count.  Upload repacks the
    # host dict canonically (insertion order, each key at its home slot
    # ``hash_slot(key, cap)`` then linear-probed to the first free row),
    # so probe chains never contain holes: the host surface may delete,
    # but in-graph execution is insert/update-only (tombstone-free) and
    # every upload starts from a compacted table.
    def to_device(self) -> np.ndarray:
        rows, cols = self.device_shape()
        slots = cols - 2
        cap = self.max_entries
        with self._lock:
            arr = np.zeros((rows, cols), dtype="<u8")
            for kb, val in self._table.items():
                k = int.from_bytes(kb, "little")
                i = hash_slot(k, cap)
                while arr[i, slots + 1] != 0:
                    i = (i + 1) % cap
                arr[i, :slots] = np.frombuffer(bytes(val), dtype="<u8")
                arr[i, slots] = k
                arr[i, slots + 1] = 1
            arr[cap, 0] = len(self._table)
        return arr

    def from_device(self, arr) -> None:
        a = np.ascontiguousarray(np.asarray(arr, dtype="<u8"))
        rows, cols = self.device_shape()
        slots = cols - 2
        with self._lock:
            # the used flags are the source of truth; the occupancy
            # control word is derived and recomputed here.  The LIVE dict
            # is mutated in place — the host-JIT fast path binds
            # ``self._table.get`` at compile time (dict identity is part
            # of the map's contract) and ``lookup_ref`` hands out value
            # bytearrays, so both must survive a device writeback.
            fresh = set()
            for i in range(self.max_entries):
                if int(a[i, slots + 1]) != 0:
                    kb = int(a[i, slots]).to_bytes(self.key_size, "little")
                    fresh.add(kb)
                    slot = self._table.get(kb)
                    if slot is None:
                        self._table[kb] = bytearray(a[i, :slots].tobytes())
                    else:
                        slot[:] = a[i, :slots].tobytes()
            for kb in [k for k in self._table if k not in fresh]:
                del self._table[kb]
            self._version += 1


class PerCpuArrayMap(ArrayMap):
    """Per-thread-slot array; reads aggregate by sum (counter idiom)."""

    kind = "percpu_array"
    N_SLOTS = 8

    def __init__(self, name: str, value_size: int, max_entries: int):
        super().__init__(name, value_size, max_entries)
        self._cpu_slots = [
            [bytearray(value_size) for _ in range(max_entries)]
            for _ in range(self.N_SLOTS)
        ]
        self._tls = threading.local()

    def _cpu(self) -> int:
        cpu = getattr(self._tls, "cpu", None)
        if cpu is None:
            cpu = threading.get_ident() % self.N_SLOTS
            self._tls.cpu = cpu
        return cpu

    def lookup_ref(self, key: bytes) -> Optional[bytearray]:
        idx = self._index(key)
        return None if idx is None else self._cpu_slots[self._cpu()][idx]

    def native_view(self) -> "NativeMapView":
        # slot selection is thread-dependent: no stable address table
        raise MapError(
            f"map {self.name}: percpu_array has no native view")

    def aggregate_u64(self, key: int, slot: int = 0) -> int:
        idx = struct.unpack("<I", struct.pack("<I", key))[0]
        if idx >= self.max_entries:
            raise MapError(f"{self.name}: key {key} out of range")
        total = 0
        for cpu in range(self.N_SLOTS):
            total += struct.unpack_from("<Q", self._cpu_slots[cpu][idx], slot * 8)[0]
        return total & U64


class PerDeviceArrayMap(ArrayMap):
    """One ArrayMap shard per device index, host merge view.

    The host selects which shard the execution tiers (and the in-graph
    device protocol) address via :meth:`set_device`; ``aggregate_u64``
    merges by sum (the counter/histogram idiom), ``device_u64`` reads
    one shard.  Because the device protocol exposes exactly the current
    shard, the in-graph lowering is the plain array lowering."""

    kind = "perdev_array"
    N_DEVICES = 8

    def __init__(self, name: str, value_size: int, max_entries: int):
        super().__init__(name, value_size, max_entries)
        self._dev_slots = [self._slots] + [
            [bytearray(value_size) for _ in range(max_entries)]
            for _ in range(self.N_DEVICES - 1)
        ]
        self._current = 0

    @property
    def current_device(self) -> int:
        return self._current

    def set_device(self, dev: int) -> None:
        """Select the shard subsequent lookups/stores (and device
        uploads) address.  Counts as a content mutation: the in-graph
        bridge must re-upload after a shard switch."""
        with self._lock:
            self._current = dev % self.N_DEVICES
            self._version += 1

    def _live_slots(self) -> List[bytearray]:
        return self._dev_slots[self._current]

    def lookup_ref(self, key: bytes) -> Optional[bytearray]:
        idx = self._index(key)
        return None if idx is None else self._live_slots()[idx]

    def update(self, key: bytes, value: bytes) -> int:
        self._check_value(value)
        idx = self._index(key)
        if idx is None:
            return -1
        with self._lock:
            self._live_slots()[idx][:] = value
            self._version += 1
        return 0

    def device_u64(self, dev: int, key: int, slot: int = 0) -> int:
        if key >= self.max_entries:
            raise MapError(f"{self.name}: key {key} out of range")
        return struct.unpack_from(
            "<Q", self._dev_slots[dev % self.N_DEVICES][key], slot * 8)[0]

    def aggregate_u64(self, key: int, slot: int = 0) -> int:
        """Host merge view: sum of one u64 slot across every shard."""
        if key >= self.max_entries:
            raise MapError(f"{self.name}: key {key} out of range")
        total = 0
        for shard in self._dev_slots:
            total += struct.unpack_from("<Q", shard[key], slot * 8)[0]
        return total & U64


class RingBufMap(BpfMap):
    """Bounded MPSC event stream — the BPF_MAP_TYPE_RINGBUF analogue.

    Producers (policy programs via the ``ringbuf_reserve`` /
    ``ringbuf_submit`` / ``ringbuf_discard`` helpers, or host code via
    :meth:`output`) append fixed-size records; consumers :meth:`drain`
    them FIFO.  State machine (identical on every tier — vm.py is the
    differential ground truth, the in-graph tiers run the same logic on
    the control words appended to the device array):

      * cursors ``head``/``tail`` are free-running u64s; live records
        occupy rows ``tail..head-1`` modulo ``max_entries``;
      * ``reserve`` first implicitly commits any still-pending
        reservation (a policy that forgot to submit cannot poison the
        ring), then fails with NULL — counting one drop — when the ring
        is full, else marks the row at ``head % max_entries`` pending
        and returns it WITHOUT zeroing;
      * ``submit`` publishes the pending record (``head += 1``);
        ``discard`` abandons it (the row is reused by the next reserve);
      * drop-on-full is the program-facing rule on every tier; the
        host-only :meth:`output` producer can instead run in
        ``overwrite`` mode, dropping the OLDEST record (decision-log /
        printk semantics), which still counts into ``drops``.
    """

    kind = "ringbuf"

    def __init__(self, name: str, value_size: int, max_entries: int,
                 *, overwrite: bool = False):
        if value_size % 8 != 0:
            raise MapError(f"ringbuf {name}: record size {value_size} "
                           "must be a multiple of 8")
        super().__init__(name, 4, value_size, max_entries)
        self._rows = [bytearray(value_size) for _ in range(max_entries)]
        self._head = 0
        self._tail = 0
        self._drops = 0
        self._pending = False
        self.overwrite = overwrite

    # -- program-facing helper surface (called by the execution tiers) -----
    def reserve_ref(self) -> Optional[bytearray]:
        with self._lock:
            if self._pending:
                self._head += 1
                self._pending = False
            if self._head - self._tail >= self.max_entries:
                self._drops += 1
                self._version += 1
                return None
            self._pending = True
            self._version += 1
            return self._rows[self._head % self.max_entries]

    def submit(self) -> int:
        with self._lock:
            if self._pending:
                self._head += 1
                self._pending = False
            self._version += 1
        return 0

    def discard(self) -> int:
        with self._lock:
            self._pending = False
            self._version += 1
        return 0

    # -- host producer/consumer surface ------------------------------------
    def output(self, data: bytes) -> int:
        """Host-side reserve+write+submit of one full record; in
        ``overwrite`` mode a full ring evicts the oldest record (counted
        as a drop) instead of rejecting the new one."""
        data = bytes(data)
        self._check_value(data)
        with self._lock:
            if self._pending:
                self._head += 1
                self._pending = False
            if self._head - self._tail >= self.max_entries:
                self._drops += 1
                if not self.overwrite:
                    self._version += 1
                    return -1
                self._tail += 1
            self._rows[self._head % self.max_entries][:] = data
            self._head += 1
            self._version += 1
        return 0

    def drain(self, max_records: Optional[int] = None) -> List[bytes]:
        """Consume up to ``max_records`` records, oldest first."""
        with self._lock:
            n = self._head - self._tail
            if max_records is not None:
                n = min(n, max_records)
            out = [bytes(self._rows[(self._tail + i) % self.max_entries])
                   for i in range(n)]
            if n:
                self._tail += n
                self._version += 1
            return out

    def peek(self) -> List[bytes]:
        """Non-destructive copy of every live record, oldest first."""
        with self._lock:
            return [bytes(self._rows[(self._tail + i) % self.max_entries])
                    for i in range(self._head - self._tail)]

    def record(self, i: int) -> bytes:
        """Random access into the live window (negative = from newest)."""
        with self._lock:
            n = self._head - self._tail
            if i < 0:
                i += n
            if not 0 <= i < n:
                raise IndexError(f"ringbuf {self.name}: index out of range")
            return bytes(self._rows[(self._tail + i) % self.max_entries])

    def clear(self) -> None:
        """Discard every live record (drop counters are cumulative and
        survive a clear)."""
        with self._lock:
            self._tail = self._head
            self._pending = False
            self._version += 1

    def __len__(self) -> int:
        with self._lock:
            return self._head - self._tail

    @property
    def head(self) -> int:
        return self._head

    @property
    def tail(self) -> int:
        return self._tail

    @property
    def drops(self) -> int:
        return self._drops

    # -- keyed surface: a ringbuf has none ---------------------------------
    def lookup_ref(self, key: bytes) -> Optional[bytearray]:
        raise MapError(f"ringbuf {self.name} has no keyed lookup; "
                       "use reserve/submit and drain()")

    def update(self, key: bytes, value: bytes) -> int:
        raise MapError(f"ringbuf {self.name} has no keyed update; "
                       "use output()")

    def delete(self, key: bytes) -> int:
        raise MapError(f"ringbuf {self.name} has no keyed delete")

    def keys(self) -> Iterator[bytes]:
        return iter(())

    # -- in-graph device protocol ------------------------------------------
    def _ctl_pos(self, w: int) -> tuple:
        slots = self.value_size // 8
        return (self.max_entries + w // slots, w % slots)

    def to_device(self) -> np.ndarray:
        rows, slots = self.device_shape()
        with self._lock:
            flat = b"".join(bytes(r) for r in self._rows)
            arr = np.zeros((rows, slots), dtype="<u8")
            arr[:self.max_entries] = np.frombuffer(flat, dtype="<u8").reshape(
                self.max_entries, slots)
            for w, v in enumerate((self._head, self._tail, self._drops,
                                   1 if self._pending else 0)):
                arr[self._ctl_pos(w)] = v
        return arr

    def from_device(self, arr) -> None:
        a = np.ascontiguousarray(np.asarray(arr, dtype="<u8"))
        vs = self.value_size
        data = a[:self.max_entries].tobytes()
        with self._lock:
            for i, r in enumerate(self._rows):
                r[:] = data[i * vs:(i + 1) * vs]
            self._head = int(a[self._ctl_pos(0)])
            # the device never consumes: its tail is the tail it was
            # uploaded with.  The host may have drained since — keep the
            # larger cursor so a host drain between upload and writeback
            # is never un-consumed (clamped to head for safety).
            self._tail = min(max(self._tail, int(a[self._ctl_pos(1)])),
                             self._head)
            self._drops = int(a[self._ctl_pos(2)])
            self._pending = bool(int(a[self._ctl_pos(3)]))
            self._version += 1


class LruHashMap(BpfMap):
    """Fixed-capacity hash with clock/LRU eviction (BPF_MAP_TYPE_LRU_HASH).

    Storage is the device layout run on the host — ``max_entries`` rows
    of ``[value, key, recency]`` plus a global clock — so every tier
    executes the identical state machine and differential tests compare
    bit-identical state:

      * lookup scans for ``key`` among occupied rows (``recency > 0``);
        a hit refreshes ``recency = ++clock`` (lookup MUTATES the map);
      * update overwrites a hit in place, else claims the row with the
        smallest recency — free rows have recency 0, so they win before
        any occupied row, and ties break to the lowest index;
      * delete frees the row (``recency = 0``); eviction means update
        never fails for capacity.

    Keys are the little-endian integer value of the declared key bytes
    (key_size <= 8, so a key fits one u64 device cell)."""

    kind = "lru_hash"

    def __init__(self, name: str, key_size: int, value_size: int,
                 max_entries: int):
        if key_size not in (4, 8):
            raise MapError(f"lru_hash {name}: key size must be 4 or 8")
        super().__init__(name, key_size, value_size, max_entries)
        self._key_ints = [0] * max_entries
        self._vals = [bytearray(value_size) for _ in range(max_entries)]
        self._rec = [0] * max_entries
        self._clock = 0
        # host acceleration only: key -> occupied row, so the hot lookup
        # path is O(1) instead of a row scan.  The row arrays above stay
        # the source of truth (they ARE the device layout); the index is
        # rebuilt wholesale on from_device()
        self._index: Dict[int, int] = {}

    def _kint(self, key: bytes) -> int:
        self._check_key(key)
        return int.from_bytes(bytes(key), "little")

    def _find(self, k: int) -> Optional[int]:
        return self._index.get(k)

    def lookup_ref(self, key: bytes) -> Optional[bytearray]:
        k = self._kint(key)
        with self._lock:
            i = self._find(k)
            if i is None:
                return None
            self._clock += 1
            self._rec[i] = self._clock
            self._version += 1
            return self._vals[i]

    def peek_ref(self, key: bytes) -> Optional[bytearray]:
        """Lookup WITHOUT refreshing recency — host introspection that
        must not perturb eviction order (snapshots, exporters)."""
        k = self._kint(key)
        with self._lock:
            i = self._find(k)
            return None if i is None else self._vals[i]

    def update(self, key: bytes, value: bytes) -> int:
        k = self._kint(key)
        self._check_value(value)
        with self._lock:
            i = self._find(k)
            if i is None:
                # victim: smallest recency, lowest index on ties — free
                # rows (recency 0) always win before any occupied row
                i = min(range(self.max_entries), key=lambda j: self._rec[j])
                if self._rec[i] > 0:
                    self._index.pop(self._key_ints[i], None)
                self._index[k] = i
            self._key_ints[i] = k
            self._vals[i][:] = value
            self._clock += 1
            self._rec[i] = self._clock
            self._version += 1
        return 0

    def delete(self, key: bytes) -> int:
        k = self._kint(key)
        with self._lock:
            i = self._find(k)
            if i is None:
                return -1
            self._index.pop(k, None)
            self._rec[i] = 0
            self._key_ints[i] = 0
            self._vals[i][:] = bytes(self.value_size)
            self._version += 1
            return 0

    def keys(self) -> Iterator[bytes]:
        with self._lock:
            out = [self._key_ints[i].to_bytes(self.key_size, "little")
                   for i in range(self.max_entries) if self._rec[i] > 0]
        return iter(out)

    def snapshot(self) -> Dict[bytes, bytes]:
        # bypass lookup_ref: a snapshot must not refresh recency
        with self._lock:
            return {self._key_ints[i].to_bytes(self.key_size, "little"):
                    bytes(self._vals[i])
                    for i in range(self.max_entries) if self._rec[i] > 0}

    def __len__(self) -> int:
        with self._lock:
            return sum(1 for r in self._rec if r > 0)

    # -- in-graph device protocol ------------------------------------------
    def to_device(self) -> np.ndarray:
        rows, cols = self.device_shape()
        slots = self.value_size // 8
        with self._lock:
            arr = np.zeros((rows, cols), dtype="<u8")
            for i in range(self.max_entries):
                arr[i, :slots] = np.frombuffer(bytes(self._vals[i]),
                                               dtype="<u8")
                arr[i, slots] = self._key_ints[i]
                arr[i, slots + 1] = self._rec[i]
            arr[self.max_entries, 0] = self._clock
        return arr

    def from_device(self, arr) -> None:
        a = np.ascontiguousarray(np.asarray(arr, dtype="<u8"))
        slots = self.value_size // 8
        with self._lock:
            for i in range(self.max_entries):
                self._vals[i][:] = a[i, :slots].tobytes()
                self._key_ints[i] = int(a[i, slots])
                self._rec[i] = int(a[i, slots + 1])
            self._clock = int(a[self.max_entries, 0])
            self._index = {self._key_ints[i]: i
                           for i in range(self.max_entries)
                           if self._rec[i] > 0}
            self._version += 1


class RingView:
    """Deque-like decoded view over a host-producer :class:`RingBufMap`.

    The dogfooding adapter: the dispatcher's decision log keeps its
    familiar ``decisions[-1]`` / ``len`` / ``clear`` surface while the
    storage is the observability plane's ring (overwrite mode: a full
    ring evicts the oldest record, like the deque it replaced).
    ``maxlen`` echoes the configured bound (including 0 = log nothing),
    and indexing decodes single records in O(1)."""

    def __init__(self, capacity: Optional[int], record_size: int,
                 encode, decode, *, name: str = "ring_view"):
        # capacity None is the legacy "unbounded" spelling; the ring is
        # the bound now, so it maps to the historical default
        self.maxlen = capacity
        cap = 4096 if capacity is None else max(int(capacity), 0)
        self._enabled = cap > 0
        self.ring = RingBufMap(name, record_size, max(cap, 1),
                               overwrite=True)
        self._enc = encode
        self._dec = decode

    def append(self, item) -> None:
        if self._enabled:
            self.ring.output(self._enc(item))

    def clear(self) -> None:
        self.ring.clear()

    def __len__(self) -> int:
        return len(self.ring) if self._enabled else 0

    def __bool__(self) -> bool:
        return len(self) > 0

    def __iter__(self):
        return iter(self._dec(r) for r in self.ring.peek())

    def __getitem__(self, i):
        if isinstance(i, slice):
            return [self._dec(r) for r in self.ring.peek()[i]]
        return self._dec(self.ring.record(i))

    @property
    def drops(self) -> int:
        return self.ring.drops


class NativeMapView:
    """Stable C-ABI view of array-family map storage for the native tier.

    One contiguous **slot directory** per shard — a ``u64[max_entries]``
    ctypes table holding the base address of every live slot bytearray.
    Exporting each slot via the buffer protocol pins its backing memory
    for the map's lifetime (a pinned bytearray cannot be resized, and
    nothing on the structured surface resizes slots — ``update()`` /
    ``from_device()`` are same-length slice assignments), so the
    addresses the directory hands to compiled code stay valid while
    Python-side tiers keep reading and writing the *same* bytes.  That
    makes native and host mutations mutually visible with no copying in
    either direction, preserving the VM's per-slot concurrency model.

    The view is refused for ``value_size < 8`` maps: the VM's
    ``ema_update`` can *grow* such slots by slice-assigning 8 bytes, and
    pinning would turn that grow into a ``BufferError`` for every tier
    sharing the map.  Version tracking: the native tier's exit path
    increments the map's ``_native_bumps`` cell (one machine add, summed
    into :attr:`BpfMap.version`), so DeviceBridge caches re-upload
    exactly as they do for the VM/JIT tiers.
    """

    def __init__(self, m: BpfMap):
        if m.kind not in ("array", "perdev_array"):
            raise MapError(
                f"map {m.name}: native view requires an array-family map")
        if m.value_size < 8:
            raise MapError(
                f"map {m.name}: native view requires value_size >= 8 "
                "(sub-8-byte slots can be grown by ema_update)")
        self.map = m
        with m.lock:
            shards = m._dev_slots if isinstance(m, PerDeviceArrayMap) \
                else [m._slots]
            # exports pin slot buffers (block resize) and keep them alive
            self._exports = [
                [(ctypes.c_ubyte * len(s)).from_buffer(s) for s in shard]
                for shard in shards]
            self._dirs = [
                (ctypes.c_uint64 * len(exps))(
                    *[ctypes.addressof(e) for e in exps])
                for exps in self._exports]
            self.dir_addrs = tuple(ctypes.addressof(d) for d in self._dirs)

    def dir_addr(self, shard: int = 0) -> int:
        """Address of the slot directory for ``shard``."""
        return self.dir_addrs[shard]

    def slot_addr(self, idx: int, shard: Optional[int] = None) -> int:
        """Address of slot ``idx``'s value bytes (current shard default)."""
        if shard is None:
            shard = self.map._current \
                if isinstance(self.map, PerDeviceArrayMap) else 0
        return self._dirs[shard][idx]


MAP_KINDS = {
    "array": ArrayMap,
    "hash": HashMap,
    "percpu_array": PerCpuArrayMap,
    "perdev_array": PerDeviceArrayMap,
    "ringbuf": RingBufMap,
    "lru_hash": LruHashMap,
}


class MapRegistry:
    """Named maps shared across programs — the composability namespace.

    Two tiers of sharing:

    * every created map is reachable by name through :meth:`get` while the
      registry lives — incidental sharing within one runtime;
    * **pinned** maps (:meth:`pin` / :meth:`get_pinned`) form an explicit
      namespace, the bpffs-pin analogue: a profiler program declares its
      EMA map ``shared=True`` and a tuner program (or host-side tooling)
      finds the same object by name, without ever holding a program
      reference.  Pinned maps survive every program detach/replace.
    """

    def __init__(self):
        self._maps: Dict[str, BpfMap] = {}
        self._pinned: Dict[str, BpfMap] = {}
        self._lock = threading.Lock()

    @staticmethod
    def _shape_of(kind: str, key_size: int, value_size: int,
                  max_entries: int) -> tuple:
        # array-family (and keyless) maps force u32 keys regardless of
        # the declaration; only the hash family keeps declared keys
        return (kind,
                key_size if kind in ("hash", "lru_hash") else 4,
                value_size, max_entries)

    def validate(self, name: str, kind: str, *, key_size: int = 4,
                 value_size: int = 8, max_entries: int = 64) -> None:
        """Shape-check a declaration against the registry WITHOUT creating
        anything — the dry-run half of a transactional bundle load."""
        if kind not in MAP_KINDS:
            raise MapError(f"unknown map kind {kind!r}")
        with self._lock:
            m = self._maps.get(name)
            if m is not None and (m.kind, m.key_size, m.value_size,
                                  m.max_entries) != self._shape_of(
                                      kind, key_size, value_size, max_entries):
                raise MapError(f"map {name}: redefinition with different shape")

    def create(self, name: str, kind: str, *, key_size: int = 4,
               value_size: int = 8, max_entries: int = 64) -> BpfMap:
        with self._lock:
            if name in self._maps:
                m = self._maps[name]
                if (m.kind, m.key_size, m.value_size, m.max_entries) != \
                        self._shape_of(kind, key_size, value_size, max_entries):
                    raise MapError(f"map {name}: redefinition with different shape")
                return m
            if kind in ("hash", "lru_hash"):
                m = MAP_KINDS[kind](name, key_size, value_size, max_entries)
            elif kind in ("array", "percpu_array", "perdev_array",
                          "ringbuf"):
                m = MAP_KINDS[kind](name, value_size, max_entries)
            else:
                raise MapError(f"unknown map kind {kind!r}")
            self._maps[name] = m
            return m

    def get(self, name: str) -> BpfMap:
        try:
            return self._maps[name]
        except KeyError:
            raise MapError(f"map {name!r} not found") from None

    # ---- pinned namespace (cross-plugin maps, the bpffs-pin analogue) ----
    def pin(self, name: str) -> BpfMap:
        """Pin an existing map into the shared namespace (idempotent)."""
        with self._lock:
            try:
                m = self._maps[name]
            except KeyError:
                raise MapError(
                    f"cannot pin {name!r}: map not found") from None
            self._pinned[name] = m
            return m

    def get_pinned(self, name: str) -> BpfMap:
        try:
            return self._pinned[name]
        except KeyError:
            raise MapError(
                f"map {name!r} is not pinned; pinned maps: "
                f"{sorted(self._pinned) or 'none'}") from None

    def unpin(self, name: str) -> None:
        with self._lock:
            if self._pinned.pop(name, None) is None:
                raise MapError(f"map {name!r} is not pinned")

    def is_pinned(self, name: str) -> bool:
        return name in self._pinned

    def pinned_names(self):
        return sorted(self._pinned)

    def __contains__(self, name: str) -> bool:
        return name in self._maps

    def names(self):
        return list(self._maps)
