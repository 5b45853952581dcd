"""The device bridge — the runtime's host-closure contract over the
policy kernel, with map state resident on the device.

Port of the single-shard ``repro.core.pallasc.DeviceBridge`` /
``compile_host``.  Every contract of the reference holds:

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
rejection); ``"torch"`` keeps them on the CPU, where the same wrapper
runs the plain PyTorch version.  Per call the ctx travels host->device
in one copy and comes back together with the return word in one copy
(they share one ``int64[n_fields + 1]`` buffer).

Deferred-mode conflict rule (as in the reference): between flushes the
device owns the kernel-written maps; a racing host write to such a map
is discarded at the next flush.  Host code that must write one calls
:meth:`flush` first.

Mesh mode (``n_shards > 1``, the shard merge) is not ported yet and
raises.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..device import require_cuda
from . import faults as _faults
from .context import Algo, Proto
from .cudac import PolicyKernel
from .maps import BpfMap
from .program import Program
from .torchc import array_to_map, map_to_array, written_map_names
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
    upload_retries: int = 0
    host_fallbacks: int = 0
    download_failures: int = 0
    domain_faults: int = 0


class DeviceBridge:
    """``fn(ctx_buf) -> int`` host closure with device-resident map state."""

    def __init__(self, prog: Program, resolved_maps: Dict[str, BpfMap],
                 vinfo=None, *, tier: str = "cuda", sync: str = "step",
                 n_shards: int = 1):
        if sync not in ("step", "deferred"):
            raise BridgeError(f"unknown bridge sync policy {sync!r}; "
                              "use 'step' or 'deferred'")
        if n_shards != 1:
            raise BridgeError(
                f"n_shards={n_shards}: the mesh-mode bridge (per-shard "
                "state and the shard merge at flush) is not ported yet; "
                "use n_shards=1")
        if tier == "cuda":
            device = require_cuda("the cuda tier")
        elif tier == "torch":
            device = torch.device("cpu")
        else:
            raise BridgeError(f"unknown bridge tier {tier!r}; "
                              "use 'cuda' or 'torch'")
        if vinfo is None:
            vinfo = verify_with_info(prog)
        self.kernel = PolicyKernel(prog, vinfo)
        if tier == "cuda":
            self.kernel.build()
        self.tier = tier
        self.sync = sync
        self.device = device
        self._prog = prog
        self._maps = resolved_maps
        self._names = list(self.kernel.names)
        self._written = written_map_names(prog, vinfo) & set(self._names)
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
        self._dev: Dict[str, torch.Tensor] = {}
        self._seen: Dict[str, int] = {}
        self._device_dirty: set = set()
        self._lock = threading.Lock()
        self.stats = BridgeStats()

    # -- host map -> device ------------------------------------------------
    def _upload_dirty(self) -> None:
        _faults.fire("bridge_upload", self.tier)
        for n in self._names:
            m = self._maps[n]
            if n not in self._dev or self._seen.get(n) != m.version:
                if n in self._device_dirty:
                    # unflushed kernel writes: the device copy wins
                    continue
                with m.lock:
                    # snapshot + version under ONE critical section, so
                    # a host write landing mid-copy is never masked
                    self._dev[n] = map_to_array(m, self.device)
                    self._seen[n] = m.version
                self.stats.map_uploads += 1

    # -- device -> host map ------------------------------------------------
    def _writeback(self, names) -> None:
        _faults.fire("bridge_download", self.tier)
        for n in names:
            arr = self._dev.get(n)
            if arr is None:
                continue
            m = self._maps[n]
            with m.lock:
                # our own writeback must not read as a host mutation
                array_to_map(arr, m)
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
                    self._device_dirty |= self._written
            else:
                self._device_dirty |= self._written
            return rv

    def flush(self) -> int:
        """Write every device-resident KERNEL-WRITABLE map back to the
        host maps; returns how many were written.  Lookup-only maps are
        never flushed."""
        with self._lock:
            _faults.fire("bridge_flush", self.tier)
            # only maps with unflushed kernel writes: under "step" a
            # successful call already wrote them back, and the host copy
            # may have moved on since (another program sharing the map)
            names = [n for n in self._names if n in self._device_dirty]
            self._writeback(names)
            self.stats.flushes += 1
            self.stats.domain_faults += self._pending_domain_faults
            self._pending_domain_faults = 0
            return len(names)

    def invalidate(self, name: Optional[str] = None) -> None:
        """Drop the device copy of ``name`` (or all maps) so the next call
        re-uploads — for host writes that bypass the versioned surface."""
        with self._lock:
            if name is None:
                self._dev.clear()
                self._seen.clear()
                self._device_dirty.clear()
            else:
                self._dev.pop(name, None)
                self._seen.pop(name, None)
                self._device_dirty.discard(name)


def compile_host(prog: Program, resolved_maps: Dict[str, BpfMap],
                 vinfo=None, *, tier: str = "cuda", sync: str = "step",
                 n_shards: int = 1) -> DeviceBridge:
    """Wrap the policy kernel (``tier="cuda"``) or its plain PyTorch
    version (``tier="torch"``) behind the host closure signature
    ``fn(ctx_buf) -> int`` the runtime invokes."""
    return DeviceBridge(prog, resolved_maps, vinfo, tier=tier, sync=sync,
                        n_shards=n_shards)
