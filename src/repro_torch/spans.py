"""In-memory spans and per-span counters of the scheduler's layers.

A caller turns the recorder on for a block::

    with spans.record() as rec:
        session.map_pending()
    rec.summary()["spans"]["walk.map_batch"]["reads"]

and nothing else turns it on: no environment variable, no flag.  With no
recorder open a span site in the program costs one module-global load
and one test (``sp = spans.enter(name) if _SPANS else None``, ``_SPANS``
being :data:`OPEN` imported by name): it reads no clock and allocates
nothing.  (``_SPANS and spans.enter(name)`` would keep the list itself
where no recorder was open, and find it true once one opens.)

While a recorder is open each span keeps its name, its start and end on
``time.perf_counter()`` (the clock the benchmark's own spans and its
device trace are put on), the index of its parent, and the host reads
(``device._count_sync``) and kernel launches (``build.count_launch``)
made while it was the innermost open span of its thread.  The stack of
open spans is per thread; a host thread that works for a span of another
thread (the group-sharded walk's) runs under it with :func:`under`.
Counters (``walk.tasks`` ...) and the admission verdicts of ``serve.wave``
spans are kept beside the spans.

A span left open by an exception is ended when its parent is left, or
when the recorder closes; a span still open when the recorder closes
ends there, and leaving it later does nothing.  Totals are worked out
off the hot path, after the recorder closed, by :meth:`Recorder.summary`.
"""
from __future__ import annotations

import threading
import time
from collections import Counter

# the open recorder, if any: span sites test this list's truth
OPEN: list = []
_OPEN_LOCK = threading.Lock()


class Span:
    """One span; ``end`` is None while it is open."""

    __slots__ = ("name", "start", "end", "parent", "reads", "launches",
                 "thread", "rec")

    def __init__(self, rec: "Recorder", name: str, start: float,
                 parent: "Span | None") -> None:
        self.rec = rec
        self.name = name
        self.start = start
        self.end = None
        self.parent = parent
        self.reads = 0
        self.launches = 0
        self.thread = threading.get_ident()


class Recorder:
    """The spans, counters and verdicts of one recording."""

    def __init__(self) -> None:
        self.spans: list[Span] = []      # in the order they were entered
        self.counters: Counter = Counter()
        # (request id, verdict instant, its serve.wave span)
        self.verdicts: list[tuple] = []
        self.outside_reads = 0           # made with no span open
        self.outside_launches = 0
        self.start = self.end = None
        self._local = threading.local()

    def __enter__(self) -> "Recorder":
        with _OPEN_LOCK:
            if OPEN:
                raise RuntimeError("a span recorder is already open")
            self.start = time.perf_counter()
            OPEN.append(self)
        return self

    def __exit__(self, *exc) -> None:
        with _OPEN_LOCK:
            OPEN.remove(self)
            self.end = time.perf_counter()
        for sp in self.spans:
            if sp.end is None:
                sp.end = self.end

    def _stack(self) -> list:
        try:
            return self._local.stack
        except AttributeError:
            self._local.stack = []
            return self._local.stack

    def _innermost(self):
        stack = self._stack()
        return stack[-1] if stack else None

    # -- read off the hot path ------------------------------------------
    def waves(self) -> list[tuple[Span, list]]:
        """Each ``serve.wave`` span with its (request id, verdict instant)
        pairs, in wave order."""
        by: dict = {}
        for rid, t, w in self.verdicts:
            by.setdefault(id(w), []).append((rid, t))
        return [(sp, by.get(id(sp), [])) for sp in self.spans
                if sp.name == "serve.wave"]

    def parents(self) -> list[int]:
        """Per span, in entry order, the index of its parent (-1: none)."""
        pos = {id(sp): i for i, sp in enumerate(self.spans)}
        return [-1 if sp.parent is None else pos[id(sp.parent)]
                for sp in self.spans]

    def totals(self) -> list[dict]:
        """Per span, in entry order: its seconds, self seconds (its length
        less the union of its children's intervals) and its reads and
        launches, own and with its descendants'."""
        n = len(self.spans)
        par = self.parents()
        kids: list[list] = [[] for _ in range(n)]
        for i, p in enumerate(par):
            if p >= 0:
                kids[p].append(i)
        out = [{"parent": par[i], "seconds": sp.end - sp.start,
                "self_reads": sp.reads,
                "self_launches": sp.launches, "reads": sp.reads,
                "launches": sp.launches} for i, sp in enumerate(self.spans)]
        # a child is entered after its parent: later indices first
        for i in range(n - 1, -1, -1):
            p = par[i]
            if p >= 0:
                out[p]["reads"] += out[i]["reads"]
                out[p]["launches"] += out[i]["launches"]
        for i, sp in enumerate(self.spans):
            covered, hi = 0.0, sp.start
            for a, b in sorted((self.spans[k].start, self.spans[k].end)
                               for k in kids[i]):
                a, b = max(a, hi), min(b, sp.end)
                if b > a:
                    covered += b - a
                    hi = b
            out[i]["self_s"] = out[i]["seconds"] - covered
        return out

    def summary(self) -> dict:
        """Per span name: ``count``, ``total_s``, ``self_s``, ``reads`` and
        ``launches`` (with the descendants'), ``self_reads`` and
        ``self_launches``; a span nested in a span of its own name adds to
        the counts and the self values only.  Beside them the reads and
        launches made with no span open, the counters, and the work:
        tasks that entered ``map_batch`` and requests decided."""
        tot = self.totals()
        names: dict = {}
        for sp, t in zip(self.spans, tot):
            e = names.setdefault(sp.name, dict.fromkeys(
                ("count", "total_s", "self_s", "reads", "launches",
                 "self_reads", "self_launches"), 0))
            e["count"] += 1
            e["self_s"] += t["self_s"]
            e["self_reads"] += t["self_reads"]
            e["self_launches"] += t["self_launches"]
            p = sp.parent
            while p is not None and p.name != sp.name:
                p = p.parent
            if p is None:
                e["total_s"] += t["seconds"]
                e["reads"] += t["reads"]
                e["launches"] += t["launches"]
        return {"spans": names,
                "outside": {"reads": self.outside_reads,
                            "launches": self.outside_launches},
                "counters": dict(self.counters),
                "work": {"tasks": self.counters.get("walk.tasks", 0),
                         "requests": len(self.verdicts)},
                "window_s": self.end - self.start}


def record() -> Recorder:
    """A recorder, opened by ``with``."""
    return Recorder()


# -- span sites: called only while a recorder is open ------------------------
def enter(name: str, t: float = None):
    """Open a span in the calling thread (at ``t``, a ``perf_counter``
    reading the caller already holds, or now); None if the recorder has
    closed since the caller's test."""
    try:
        rec = OPEN[0]
    except IndexError:
        return None
    stack = rec._stack()
    sp = Span(rec, name, time.perf_counter() if t is None else t,
              stack[-1] if stack else None)
    rec.spans.append(sp)
    stack.append(sp)
    return sp


def leave(sp, t: float = None) -> None:
    """End ``sp`` (a falsy ``sp`` is a span not recorded), and any span
    still open inside it."""
    if not sp or sp.end is not None:
        return
    end = time.perf_counter() if t is None else t
    stack = sp.rec._stack()
    if sp not in stack:
        return
    while True:
        top = stack.pop()
        top.end = end
        if top is sp:
            return


def add(counter: str, n: int = 1) -> None:
    """Add ``n`` to a counter of the open recorder."""
    try:
        OPEN[0].counters[counter] += n
    except IndexError:
        pass


def decided(rid: int) -> None:
    """Stamp the final verdict of request ``rid`` now, on the innermost
    ``serve.wave`` span open in the calling thread (none: not kept)."""
    try:
        rec = OPEN[0]
    except IndexError:
        return
    t = time.perf_counter()
    for sp in reversed(rec._stack()):
        if sp.name == "serve.wave":
            rec.verdicts.append((rid, t, sp))
            return


def current():
    """The calling thread's innermost open span, or None."""
    try:
        return OPEN[0]._innermost()
    except IndexError:
        return None


def under(parent, fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` with ``parent`` (a span of another thread,
    or falsy: none) as the innermost open span of the calling thread."""
    if not parent or parent.end is not None:
        return fn(*args, **kwargs)
    stack = parent.rec._stack()
    stack.append(parent)
    try:
        return fn(*args, **kwargs)
    finally:
        # spans an exception left open above it end now; ``parent`` is
        # its own thread's to end
        depth = stack.index(parent) if parent in stack else len(stack)
        end = time.perf_counter()
        for sp in stack[depth + 1:]:
            sp.end = end
        del stack[depth:]


# -- the two counters: called under their own locks --------------------------
def count_read() -> None:
    try:
        rec = OPEN[0]
    except IndexError:
        return
    sp = rec._innermost()
    if sp is None:
        rec.outside_reads += 1
    else:
        sp.reads += 1


def count_launch() -> None:
    try:
        rec = OPEN[0]
    except IndexError:
        return
    sp = rec._innermost()
    if sp is None:
        rec.outside_launches += 1
    else:
        sp.launches += 1
