"""Spans of the port's own layers, recorded while a ``torch.profiler``
session runs.

An instrumented site reads torch's own fast flag,
``torch.autograd.profiler._is_profiler_enabled``, once.  With the flag
off it writes ``STORE.off = True`` and records nothing: no other switch
turns spans on.  ``span`` is that gate around a block:

    with trace.span(trace.DATA_BATCH, step):
        ...

The dispatcher's ``decide()``, the one hot site, gates inline: it keeps
its spans' boundaries in locals (``STORE.start()``, then
``perf_counter_ns()``) and stores them with one ``STORE.decision(...)``
as it returns.

A span is stored once, as it ends, as one row of five integers in one
flat list: a name (an index into ``NAMES``), its start and end on
``time.perf_counter_ns()``, its thread and a request id (a decision's
sequence number, a step index; -1 takes its parent's).  A decision's
three rows go in with one ``extend``.  A span's parent, the span that
encloses it on the same thread (-1 at a root), and the id it takes from
it are found when the store is read.  The list holds up to ``CAP``
spans; later ones are counted in ``drops``.  Extending a list by a tuple
is atomic in CPython, so the recording half takes no lock and keeps
nothing the collector tracks: a row that races a new session goes to
the dropped one.

**Sessions.**  A span that starts while ``off`` is set (some
instrumented site has seen the flag off since the last span started)
begins a new session and drops the older one's spans: the store holds
the newest profiler session.  A span is stored in the session it started
in: one that started before its session began is not stored, and one
that ends after the profiler has stopped is, so that a span longer than
the gap between its start and the session's end (a batch on the
prefetch thread) is not lost.  The first span a session starts on the main thread
first opens and closes one ``record_function(CLOCK)`` range between two
host-clock readings (``clock_anchor()``): a profiler event list and the
store meet on one clock through the offset between that range and those
readings.

A ``record_function`` range costs microseconds even with the profiler
off, and a range opened on a second thread is not recorded, so spans
are kept here, not in the profiler's timeline.
"""

from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch.autograd.profiler as _prof

NAMES = ("dispatch.decide", "dispatch.lookup", "dispatch.log",
         "bridge.call", "bridge.upload", "bridge.enqueue", "bridge.wait",
         "bridge.writeback", "trainer.data_wait", "data.batch")
(DISPATCH_DECIDE, DISPATCH_LOOKUP, DISPATCH_LOG, BRIDGE_CALL, BRIDGE_UPLOAD,
 BRIDGE_ENQUEUE, BRIDGE_WAIT, BRIDGE_WRITEBACK, TRAINER_DATA_WAIT,
 DATA_BATCH) = range(len(NAMES))
CAP = 1 << 22
# the profiler range that anchors the store's clock on the profiler's
CLOCK = "repro_torch.trace.clock"

_ns = time.perf_counter_ns
_ident = threading.get_ident


class SpanStore:
    """The process-wide span store (``STORE``).  ``start``, ``add`` and
    ``decision`` are the recording half, called only after the flag read
    true; the rest reads the newest session."""

    def __init__(self):
        self.off = True             # the flag was seen off since a span began
        self._lock = threading.Lock()
        # the newest session: name, start, end, thread, id a span
        self._rows: List[int] = []
        self._since = 0             # the host clock as the session began
        self._room = 0              # the rows a decision may find stored
        self._anchor: Optional[Tuple[int, int]] = None
        self._main = threading.main_thread().ident
        self.drops = 0
        self.sessions = 0

    # -- recording --------------------------------------------------------
    def start(self) -> int:
        """A span's start, now: begins a session where ``off`` is set, and
        takes the session's clock anchor first on the main thread."""
        if self.off:
            self._begin()
        if self._anchor is None and _ident() == self._main:
            self._take_anchor()
        return _ns()

    def add(self, name: int, start: int, rid: int = -1) -> None:
        """Store span ``name`` of this thread, from ``start`` to now."""
        end = _ns()
        rows = self._rows
        if start < self._since:
            return
        if len(rows) >= 5 * CAP:
            self._drop(1)
            return
        rows.extend((name, start, end, _ident(), rid))

    def decision(self, seq: int, t0: int, t1: int, t2: int,
                 t3: int) -> None:
        """Store a decision's spans, each with id ``seq``: the lookup from
        ``t0`` to ``t1``, the log append from ``t2`` to ``t3`` and the
        whole call from ``t0`` to now; the three together, or all three
        counted in ``drops``."""
        end = _ns()
        rows = self._rows
        if t0 < self._since:
            return
        if len(rows) > self._room:
            self._drop(3)
            return
        tid = _ident()
        # names DISPATCH_LOOKUP, DISPATCH_LOG, DISPATCH_DECIDE
        rows.extend((1, t0, t1, tid, seq, 2, t2, t3, tid, seq,
                     0, t0, end, tid, seq))

    def _drop(self, n: int) -> None:
        with self._lock:
            self.drops += n

    def _begin(self) -> None:
        with self._lock:
            if not self.off:
                return                  # another thread began it
            # the new start before the new list: a span of the older
            # session that finds the new list also finds the new start
            self._since = _ns()
            self._rows = []
            self._room = 5 * (CAP - 3)
            self._anchor = None
            self.drops = 0
            self.sessions += 1
            self.off = False            # last: the new session is in place

    def _take_anchor(self) -> None:
        a = _ns()
        with _prof.record_function(CLOCK):
            pass
        self._anchor = (a, _ns())

    # -- reading the newest session ---------------------------------------
    def _table(self) -> np.ndarray:
        """The newest session's spans as an (n, 5) int64 array of rows
        (name, start, end, thread, id), in the order they ended."""
        rows = self._rows
        t = np.array(rows[:len(rows)], np.int64).reshape(-1, 5)
        return t[np.argsort(t[:, 2], kind="stable")]

    def _tree(self) -> Dict[str, np.ndarray]:
        """Every stored span, as ``_table`` orders them: ``name``,
        ``start_ns``, ``end_ns``, ``parent`` (the row of the span that
        encloses it on its thread; -1 at a root) and ``id`` (its parent's
        where it carries none)."""
        t = self._table()
        start, tid, rid = (t[:, k].tolist() for k in (1, 3, 4))
        parent = [-1] * len(t)
        # latest end first, then earliest start: a span comes after every
        # span that encloses it; each thread keeps its chain of enclosing
        # spans, and one that starts later than the next span cannot
        # enclose it or any span after it
        order = np.lexsort((-np.arange(len(t)), t[:, 1], -t[:, 2]))
        chains: Dict[int, list] = {}
        for i in order.tolist():
            chain = chains.setdefault(tid[i], [])
            while chain and start[chain[-1]] > start[i]:
                chain.pop()
            if chain:
                p = parent[i] = chain[-1]
                if rid[i] < 0:
                    rid[i] = rid[p]
            chain.append(i)
        return {"name": t[:, 0], "start_ns": t[:, 1], "end_ns": t[:, 2],
                "parent": np.asarray(parent, np.int64),
                "id": np.asarray(rid, np.int64)}

    def spans(self, name: str) -> Dict[str, np.ndarray]:
        """The stored spans of ``name``: ``dur_ns``, ``id`` and
        ``start_ns`` (host clock), in the order they ended (empty arrays
        where there are none)."""
        t = self._table()
        mine = t[:, 0] == NAMES.index(name)
        rid = t[mine, 4]
        if (rid < 0).any():
            rid = self._tree()["id"][mine]
        return {"dur_ns": t[mine, 2] - t[mine, 1], "id": rid,
                "start_ns": t[mine, 1]}

    def self_ns(self, name: str) -> np.ndarray:
        """Each stored span of ``name``: its duration less the time its
        child spans cover."""
        r = self._tree()
        dur = r["end_ns"] - r["start_ns"]
        child = np.zeros(len(dur), np.int64)
        kids = r["parent"] >= 0
        np.add.at(child, r["parent"][kids], dur[kids])
        mine = r["name"] == NAMES.index(name)
        return dur[mine] - child[mine]

    def counters(self) -> Dict[str, int]:
        """``stored`` (spans of the newest session), ``drops`` (its spans
        past the cap) and ``sessions`` (begun since the store was made or
        cleared)."""
        with self._lock:
            return {"stored": len(self._rows) // 5, "drops": self.drops,
                    "sessions": self.sessions}

    def clock_anchor(self) -> Optional[Tuple[int, int]]:
        """The host clock (``perf_counter_ns``) just before and just after
        the newest session's ``CLOCK`` range; None before it has one.
        Map by the second reading against the range's end: the first
        range of a profiler session pays its set-up on entry, while the
        exit is short and steady."""
        return self._anchor

    def clear(self) -> None:
        """Drop every span and counter, as the store began."""
        with self._lock:
            self.off = True
            self._rows = []
            self._anchor = None
            self.drops = 0
            self.sessions = 0


class span:
    """``with span(NAME, rid):`` stores the block as span ``NAME`` while a
    ``torch.profiler`` session runs (``rid`` -1 takes the enclosing
    span's id); with the profiler off it reads the flag, writes
    ``STORE.off`` and records nothing."""

    __slots__ = ("name", "rid", "t0")

    def __init__(self, name: int, rid: int = -1):
        self.name, self.rid = name, rid

    def __enter__(self) -> None:
        if _prof._is_profiler_enabled:
            self.t0 = STORE.start()
        else:
            STORE.off = True
            self.t0 = None

    def __exit__(self, *exc) -> bool:
        if self.t0 is not None:
            STORE.add(self.name, self.t0, self.rid)
        return False


STORE = SpanStore()
spans = STORE.spans
self_ns = STORE.self_ns
counters = STORE.counters
clock_anchor = STORE.clock_anchor
clear = STORE.clear
