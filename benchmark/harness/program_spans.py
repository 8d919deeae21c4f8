"""The card's idle time assigned to the program's own spans.

The port opens ``torch.profiler.record_function`` ranges named
``ukbb.<layer>...`` around its host work (``utils/timing.py`` of the
port).  In a traced window each instant at which no kernel, copy or set
ran on the card (the complement of ``Trace.busy`` inside
``Trace.window_ns``) belongs to the innermost ``ukbb.`` span open on the
host at that instant: the shortest, as ``Trace._label`` picks among the
benchmark's own spans.  An instant under no ``ukbb.`` span belongs to
none.  The readers of ``idle_*_s.cohort`` sum these seconds by the
prefix of their layer, per completed subject.

A program that opens no such span (one older than its spans) gives an
empty assignment, and each reader then reads 0.0.
"""

from __future__ import annotations

import heapq
from typing import Dict, List, Optional, Tuple

PREFIX = "ukbb."


def idle_gaps(trace) -> List[Tuple[int, int]]:
    """The window's stretches with no device work, in nanoseconds."""
    lo, hi = trace.window_ns
    out, t = [], lo
    for s, e in trace.busy:
        if s > t:
            out.append((t, min(s, hi)))
        t = max(t, e)
        if t >= hi:
            break
    if t < hi:
        out.append((t, hi))
    return [(s, e) for s, e in out if e > s]


def idle_by_span(trace, prefix: str = PREFIX) -> Dict[Optional[str], float]:
    """Idle seconds of the traced window by the name of the innermost
    span whose name starts with ``prefix`` (key None: under no such
    span)."""
    lo, hi = trace.window_ns
    spans = sorted((s, e, n) for s, e, n in trace.host
                   if n.startswith(prefix) and e > lo and s < hi)
    gaps = idle_gaps(trace)
    out: Dict[Optional[str], float] = {}
    if not gaps:
        return out
    # the boundaries where the innermost span can change, inside the gaps
    cuts = sorted({x for s, e, _ in spans for x in (s, e)
                   if lo < x < hi} | {x for g in gaps for x in g})
    open_: list = []       # heap of (duration, end, name)
    i = g = 0
    for a, b in zip(cuts, cuts[1:]):
        while i < len(spans) and spans[i][0] <= a:
            s, e, n = spans[i]
            heapq.heappush(open_, (e - s, e, n))
            i += 1
        while g < len(gaps) and gaps[g][1] <= a:
            g += 1
        if g == len(gaps):
            break
        if gaps[g][0] > a:
            continue       # [a, b) is busy: cuts hold every gap's edges
        while open_ and open_[0][1] <= a:
            heapq.heappop(open_)
        # the shortest open span; one that ended is dropped lazily when it
        # reaches the top, so the top is always open
        name = open_[0][2] if open_ else None
        out[name] = out.get(name, 0.0) + (b - a) * 1e-9
    return out


def _assigned(trace) -> Dict[Optional[str], float]:
    """:func:`idle_by_span` of ``trace``, computed once per trace (three
    readers ask for it)."""
    got = getattr(trace, "_idle_by_span", None)
    if got is None:
        got = trace._idle_by_span = idle_by_span(trace)
    return got


def idle_seconds(trace, layer_prefix: str) -> float:
    """Idle seconds whose innermost span starts with ``layer_prefix``."""
    return sum(v for n, v in _assigned(trace).items()
               if n is not None and n.startswith(layer_prefix))


def leaf_share(trace) -> float:
    """Share of the window's idle time under a leaf span: any ``ukbb.``
    span but ``ukbb.subject`` and ``ukbb.stage.*``."""
    by = _assigned(trace)
    total = sum(by.values())
    leaf = sum(v for n, v in by.items() if n is not None
               and n != PREFIX + "subject"
               and not n.startswith(PREFIX + "stage."))
    return leaf / total if total > 0 else 0.0


def per_subject(run, layer_prefix: str) -> Optional[float]:
    """A reader's value: idle seconds under ``layer_prefix`` over the
    subjects completed in the window; None without a trace or with no
    completed subject."""
    if run.trace is None:
        return None
    done = sum(1 for p in run.record.get("passes", ()) if p.ok)
    if not done:
        return None
    return idle_seconds(run.trace, layer_prefix) / done
