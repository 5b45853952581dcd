"""The device bridge — the runtime's host-closure contract over the
policy kernel, with map state resident on the device.

Port of ``repro.core.pallasc.DeviceBridge`` / ``compile_host``.  Every
contract of the reference holds:

  * **upload** — version-gated: a map is (re-)uploaded only when the
    host mutated it since the bridge last saw it (``BpfMap.version``;
    the first call seeds everything).  The snapshot and the version are
    read under ONE map-lock critical section.  Two bridges sharing a
    pinned map stay coherent through the host copy.
  * **download** — statically scoped: only maps the verified program
    can write (:func:`repro_torch.core.torchc.written_map_names`) sync
    back; lookup-only maps never round-trip.  ``sync="step"`` writes
    them back after every call; ``"deferred"`` keeps them on the device
    and writes back only on :meth:`DeviceBridge.flush` (every T3
    boundary).
  * **flush()** — writes back the kernel-writable maps that hold
    unflushed kernel writes; a lookup-only map's device copy never
    overwrites host mutations.  (The reference writes back every
    kernel-writable map here, which under ``"step"`` can revert a host
    write that landed after the last call — see ROADMAP section C.)
  * **fault containment** — the ``bridge_upload`` / ``bridge_download``
    / ``bridge_flush`` fault points fire; a failed upload retries with
    bounded backoff, then that one call runs on the host VM and is
    counted in ``stats.host_fallbacks`` (the reference's counted
    containment, never a quiet path); a failed step writeback is
    deferred to the next flush; out-of-domain tuner decisions are
    counted on the host and drained into ``stats.domain_faults`` at
    flush.

Tiers: ``"cuda"`` keeps the maps on the CUDA device and runs the
hand-written kernel (:class:`repro_torch.core.cudac.PolicyKernel`,
built when the bridge is constructed — a build failure is a load-time
rejection); ``"cuda32"`` runs the same decision as the pair-form kernel
over ``[lo, hi]`` pairs (:mod:`repro_torch.core.pair`; ``lru_hash``
programs are rejected, as the reference's ``pallas32`` rejects them);
``"torch"`` keeps the maps on the CPU, where the same wrapper runs the
plain PyTorch version.  Per call the ctx travels host->device in one
copy and comes back together with the return word in one copy (they
share one ``int64[n_fields + 1]`` buffer, viewed as pairs on
``cuda32``).

Deferred-mode conflict rule (as in the reference): between flushes the
device owns the kernel-written maps; a racing host write to such a map
is discarded at the next flush.  Host code that must write one calls
:meth:`flush` first.

Mesh mode (``n_shards > 1``, the reference's ``pallasc.py:348-361``):
one device-resident state copy per shard (device or rank index, chosen
with :meth:`DeviceBridge.set_shard`), each seeded from the host maps at
its own upload and carrying a per-map write cursor (kernel calls that
wrote the map on that shard).  Per-call writeback cannot reconcile
shards, so mesh mode requires ``sync="deferred"``; ``flush()`` runs the
deterministic shard merge (:mod:`repro_torch.core.shardmerge`): counter
slots land as the sum of per-shard deltas, ``merge="max"`` cells go to
the shard with the highest cursor, hash maps reconcile per key.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..device import require_cuda
from . import faults as _faults
from .context import Algo, Proto
from .cudac import PolicyKernel, check_supported32
from .maps import BpfMap
from .pair import array32_to_map, map_to_array32
from .program import Program
from .shardmerge import (MERGEABLE_KINDS, Shard, merge_map_shards,
                         pairs_to_u64)
from .torchc import (array_to_map, map_to_array, words_to_pairs,
                     written_map_names)
from .verifier import verify_with_info

M64 = (1 << 64) - 1


class BridgeError(Exception):
    pass


@dataclasses.dataclass
class BridgeStats:
    """Introspection counters; tests and the chip smoke assert on these
    (e.g. "warm repeat calls perform zero map uploads")."""
    calls: int = 0
    map_uploads: int = 0
    map_downloads: int = 0
    flushes: int = 0
    # multi-shard bridges: merged flushes performed and hash keys dropped
    # to capacity (E2BIG) during a merge
    shard_merges: int = 0
    merge_dropped_keys: int = 0
    upload_retries: int = 0
    host_fallbacks: int = 0
    download_failures: int = 0
    domain_faults: int = 0


TIERS = ("cuda", "cuda32", "torch")


class DeviceBridge:
    """``fn(ctx_buf) -> int`` host closure with device-resident map state."""

    def __init__(self, prog: Program, resolved_maps: Dict[str, BpfMap],
                 vinfo=None, *, tier: str = "cuda", sync: str = "step",
                 n_shards: int = 1):
        if sync not in ("step", "deferred"):
            raise BridgeError(f"unknown bridge sync policy {sync!r}; "
                              "use 'step' or 'deferred'")
        if n_shards < 1:
            raise BridgeError(f"n_shards must be >= 1, got {n_shards}")
        if n_shards > 1 and sync != "deferred":
            raise BridgeError(
                "multi-shard bridges accumulate per-shard deltas and merge "
                "at flush(); per-call writeback cannot reconcile shards — "
                "use sync='deferred'")
        if tier not in TIERS:
            raise BridgeError(f"unknown bridge tier {tier!r}; "
                              f"use one of {', '.join(TIERS)}")
        if tier == "cuda32":
            check_supported32(prog)
        device = require_cuda(f"the {tier} tier") if tier != "torch" \
            else torch.device("cpu")
        if vinfo is None:
            vinfo = verify_with_info(prog)
        self.kernel = PolicyKernel(prog, vinfo)
        if device.type == "cuda":
            self.kernel.build()
        self.tier = tier
        self.word_width = 32 if tier == "cuda32" else 64
        self.sync = sync
        self.device = device
        self._prog = prog
        self._maps = resolved_maps
        self._names = list(self.kernel.names)
        self._written = written_map_names(prog, vinfo) & set(self._names)
        self.n_shards = n_shards
        if n_shards > 1:
            bad = sorted(n for n in self._written
                         if prog.map_decl(n).kind not in MERGEABLE_KINDS)
            if bad:
                kinds = ", ".join(f"{n} ({prog.map_decl(n).kind})"
                                  for n in bad)
                raise BridgeError(
                    f"policy '{prog.name}' writes map(s) with no order-free "
                    f"shard merge: {kinds}; mergeable kinds: "
                    f"{', '.join(MERGEABLE_KINDS)}")
        n = self.kernel.n_fields
        self._n = n
        # ctx and the return word share one buffer: one copy each way
        pin = device.type == "cuda"
        self._io = torch.zeros(n + 1, dtype=torch.int64, device=device)
        self._io_host = torch.zeros(n + 1, dtype=torch.int64,
                                    pin_memory=pin)
        self._io_np = self._io_host.numpy()
        self.upload_retries = 2
        self.retry_backoff_s = 0.001
        self._host_fn: Optional[Callable[[bytearray], int]] = None
        self._pending_domain_faults = 0
        self._domain_offs = None
        if prog.section == "tuner":
            ct = prog.ctx_type
            self._domain_offs = (ct.offset_of("algorithm"),
                                 ct.offset_of("protocol"),
                                 ct.offset_of("n_channels"))
        self._shard = 0
        # one device-resident state copy per shard; the call path reads
        # the selected shard's through the properties below
        self._devs: List[Dict[str, torch.Tensor]] = \
            [{} for _ in range(n_shards)]
        self._seens: List[Dict[str, int]] = [{} for _ in range(n_shards)]
        self._dirtys: List[set] = [set() for _ in range(n_shards)]
        # mesh mode only: per-shard seed snapshots (u64 host images, the
        # merge's bases) and per-map write cursors
        self._bases: List[Dict[str, np.ndarray]] = \
            [{} for _ in range(n_shards)]
        self._cursors: List[Dict[str, int]] = [{} for _ in range(n_shards)]
        self._lock = threading.Lock()
        self.stats = BridgeStats()

    @property
    def _dev(self) -> Dict[str, torch.Tensor]:
        return self._devs[self._shard]

    @property
    def _seen(self) -> Dict[str, int]:
        return self._seens[self._shard]

    @property
    def _device_dirty(self) -> set:
        return self._dirtys[self._shard]

    def set_shard(self, shard: int) -> None:
        """Select which shard (device or rank index) subsequent calls run
        against."""
        if not 0 <= shard < self.n_shards:
            raise BridgeError(
                f"shard {shard} out of range for n_shards={self.n_shards}")
        with self._lock:
            self._shard = shard

    # -- host map -> device ------------------------------------------------
    def _upload_dirty(self) -> None:
        _faults.fire("bridge_upload", self.tier)
        to_array = map_to_array32 if self.word_width == 32 else map_to_array
        for n in self._names:
            m = self._maps[n]
            if n not in self._dev or self._seen.get(n) != m.version:
                if n in self._device_dirty:
                    # unflushed kernel writes: the device copy wins
                    continue
                with m.lock:
                    # snapshot + version under ONE critical section, so
                    # a host write landing mid-copy is never masked
                    self._dev[n] = to_array(m, self.device)
                    self._seen[n] = m.version
                    if self.n_shards > 1 and n in self._written:
                        # the merge base: the state THIS shard was seeded
                        # from; its flush contribution is a delta on it
                        self._bases[self._shard][n] = m.to_device()
                        self._cursors[self._shard][n] = 0
                self.stats.map_uploads += 1

    # -- device -> host map ------------------------------------------------
    def _writeback(self, names) -> None:
        _faults.fire("bridge_download", self.tier)
        to_map = array32_to_map if self.word_width == 32 else array_to_map
        for n in names:
            arr = self._dev.get(n)
            if arr is None:
                continue
            m = self._maps[n]
            with m.lock:
                # our own writeback must not read as a host mutation
                to_map(arr, m)
                self._seen[n] = m.version
            self._device_dirty.discard(n)
            self.stats.map_downloads += 1

    # -- fault containment -------------------------------------------------
    def _retry_upload(self) -> bool:
        for attempt in range(self.upload_retries):
            time.sleep(self.retry_backoff_s * (attempt + 1))
            self.stats.upload_retries += 1
            try:
                self._upload_dirty()
                return True
            except Exception:
                continue
        return False

    def _host_tier_fn(self) -> Callable[[bytearray], int]:
        """The host VM over the HOST maps, for calls whose upload failed
        after every retry (counted in ``stats.host_fallbacks``)."""
        if self._host_fn is None:
            from .vm import VM
            self._host_fn = VM(self._prog.insns, self._maps,
                               subprogs=self._prog.subprogs).run
        return self._host_fn

    # -- the runtime host-closure contract ---------------------------------
    def __call__(self, ctx_buf: bytearray) -> int:
        with self._lock:
            self.stats.calls += 1
            try:
                self._upload_dirty()
            except Exception:
                if not self._retry_upload():
                    self.stats.host_fallbacks += 1
                    return self._host_tier_fn()(ctx_buf)
            n = self._n
            self._io_np[:n] = np.frombuffer(ctx_buf, dtype="<i8")
            ctx = self._io[:n]
            ctx.copy_(self._io_host[:n], non_blocking=True)
            if self.word_width == 32:
                self.kernel.launch32(words_to_pairs(ctx),
                                     words_to_pairs(self._io[n:]).reshape(2),
                                     self._dev)
            else:
                self.kernel.launch(ctx, self._io[n:], self._dev)
            self._io_host.copy_(self._io, non_blocking=True)
            if self.device.type == "cuda":
                torch.cuda.current_stream().synchronize()
            ctx_buf[:] = self._io_np[:n].tobytes()
            rv = int(self._io_np[n]) & M64
            if self._domain_offs is not None:
                ao, po, co = self._domain_offs
                a = int.from_bytes(ctx_buf[ao:ao + 8], "little")
                p = int.from_bytes(ctx_buf[po:po + 8], "little")
                c = int.from_bytes(ctx_buf[co:co + 8], "little")
                if (a or p or c) and (a >= Algo.COUNT or p >= Proto.COUNT
                                      or c > 0xFFFFFFFF):
                    self._pending_domain_faults += 1
            if self.sync == "step":
                try:
                    self._writeback(self._written)
                except Exception:
                    # contained: keep the maps device-dirty so flush()
                    # retries the writeback later
                    self.stats.download_failures += 1
                    self._device_dirty.update(self._written)
            else:
                self._device_dirty.update(self._written)
                if self.n_shards > 1:
                    cur = self._cursors[self._shard]
                    for w in self._written:
                        cur[w] = cur.get(w, 0) + 1
            return rv

    def flush(self) -> int:
        """Write every device-resident KERNEL-WRITABLE map back to the
        host maps (mesh mode: merge the shards into them); returns how
        many were written.  Lookup-only maps are never flushed."""
        with self._lock:
            _faults.fire("bridge_flush", self.tier)
            if self.n_shards > 1:
                synced = self._merged_flush()
            else:
                # only maps with unflushed kernel writes: under "step" a
                # successful call already wrote them back, and the host
                # copy may have moved on since (another program sharing
                # the map)
                names = [n for n in self._names if n in self._device_dirty]
                self._writeback(names)
                synced = len(names)
            self.stats.flushes += 1
            self.stats.domain_faults += self._pending_domain_faults
            self._pending_domain_faults = 0
            return synced

    def _host_image(self, arr: torch.Tensor) -> np.ndarray:
        a = arr.detach().cpu().numpy()
        return pairs_to_u64(a) if self.word_width == 32 else a.view("<u8")

    def _merged_flush(self) -> int:
        """Mesh-mode flush: reconcile every shard's copy of each written
        map against the CURRENT host state with the deterministic shard
        merge, then drop all shard copies so the next call per shard
        re-seeds from the merged view.  Returns maps merged."""
        synced = 0
        for n in self._names:
            if n not in self._written:
                continue
            decl = self._prog.map_decl(n)
            shards = []
            for s in range(self.n_shards):
                arr = self._devs[s].get(n)
                if arr is None or self._cursors[s].get(n, 0) == 0:
                    continue  # never seeded, or seeded but never written
                shards.append(Shard(s, self._host_image(arr),
                                    self._cursors[s][n], self._bases[s][n]))
            if not shards:
                continue
            mstats: dict = {}
            m = self._maps[n]
            with m.lock:
                m.from_device(merge_map_shards(decl, m.to_device(), shards,
                                               mstats))
            self.stats.merge_dropped_keys += mstats.get("dropped_keys", 0)
            self.stats.map_downloads += 1
            synced += 1
            # every shard copy is stale against the merged host state;
            # drop them so the next per-shard call re-seeds
            for s in range(self.n_shards):
                self._drop(s, n)
        if synced:
            self.stats.shard_merges += 1
        return synced

    def _drop(self, s: int, name: str) -> None:
        self._devs[s].pop(name, None)
        self._seens[s].pop(name, None)
        self._dirtys[s].discard(name)
        self._bases[s].pop(name, None)
        self._cursors[s].pop(name, None)

    def invalidate(self, name: Optional[str] = None) -> None:
        """Drop the device copy of ``name`` (or all maps) so the next call
        re-uploads — for host writes that bypass the versioned surface."""
        with self._lock:
            for s in range(self.n_shards):
                for n in ([name] if name is not None else self._names):
                    self._drop(s, n)


def compile_host(prog: Program, resolved_maps: Dict[str, BpfMap],
                 vinfo=None, *, tier: str = "cuda", sync: str = "step",
                 n_shards: int = 1) -> DeviceBridge:
    """Wrap the policy kernel (``tier="cuda"``), its pair form
    (``"cuda32"``) or its plain PyTorch version (``"torch"``) behind the
    host closure signature ``fn(ctx_buf) -> int`` the runtime invokes.
    ``n_shards > 1`` builds a mesh-mode bridge (one device-resident state
    copy per shard, :meth:`DeviceBridge.set_shard`; ``flush()`` merges) —
    requires ``sync="deferred"``."""
    return DeviceBridge(prog, resolved_maps, vinfo, tier=tier, sync=sync,
                        n_shards=n_shards)
