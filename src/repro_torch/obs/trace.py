"""Span/event recorder exporting Chrome trace-event JSON (Perfetto).

`TraceRecorder` records against an injectable monotonic clock — the same
clock the serving pipeline runs on, so spans line up exactly with ticket
latency stamps. Three event shapes cover the serving lifecycle:

* complete spans (`complete` / the `span` context manager, phase "X") —
  flush/stage/dispatch/retire work on a bucket lane;
* async span pairs (`async_begin`/`async_end`, phases "b"/"e") — one per
  ticket, spanning enqueue→retire across lanes, matched by (cat, id);
* instant events (`instant`, phase "i") — migrations, replication
  passes, drift verdicts, epoch bumps.

`to_chrome()` renders the buffer in the Chrome trace-event JSON format
(timestamps shifted to start near zero, seconds → microseconds) which
https://ui.perfetto.dev loads directly. A disabled recorder is a cheap
no-op on every recording path so tracing-off serving stays overhead-free.

Stdlib-only: no torch/numpy at module scope (tools import this without
the accelerator stack).
"""
from __future__ import annotations

import json
import time
from contextlib import contextmanager
from typing import Callable

DEFAULT_CLOCK: Callable[[], float] = time.monotonic

_US = 1e6  # recorder clocks are seconds; trace-event ts/dur are microseconds


class TraceRecorder:
    """Bounded in-memory event buffer with Chrome-trace export.

    Events beyond `max_events` are dropped (counted in `dropped`) rather
    than growing without bound under a long serving run. `enabled=False`
    makes every recording method return immediately.
    """

    def __init__(self, clock: Callable[[], float] = DEFAULT_CLOCK, *,
                 enabled: bool = True, max_events: int = 200_000) -> None:
        """Create a recorder over `clock` (a monotonic float-seconds
        callable — the pipeline injects its own)."""
        self.clock = clock
        self.enabled = enabled
        self.max_events = max_events
        self.events: list[dict] = []
        self.dropped = 0

    def __len__(self) -> int:
        """Number of buffered events."""
        return len(self.events)

    def _emit(self, event: dict) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(event)

    def complete(self, name: str, t0: float, t1: float, *,
                 cat: str = "serve", tid: str = "main",
                 args: dict | None = None) -> None:
        """Record a complete span (phase "X") from clock times t0..t1."""
        if not self.enabled:
            return
        self._emit({"ph": "X", "name": name, "cat": cat, "tid": tid,
                    "ts": t0, "dur": max(0.0, t1 - t0),
                    "args": args or {}})

    @contextmanager
    def span(self, name: str, *, cat: str = "serve", tid: str = "main",
             args: dict | None = None):
        """Context manager recording a complete span around its body."""
        if not self.enabled:
            yield
            return
        t0 = self.clock()
        try:
            yield
        finally:
            self.complete(name, t0, self.clock(), cat=cat, tid=tid,
                          args=args)

    def instant(self, name: str, *, ts: float | None = None,
                cat: str = "serve", tid: str = "main",
                args: dict | None = None) -> None:
        """Record an instant event (phase "i", process scope)."""
        if not self.enabled:
            return
        self._emit({"ph": "i", "s": "p", "name": name, "cat": cat,
                    "tid": tid, "ts": self.clock() if ts is None else ts,
                    "args": args or {}})

    def async_begin(self, name: str, id: int, *, ts: float | None = None,
                    cat: str = "ticket", tid: str = "main",
                    args: dict | None = None) -> None:
        """Open an async span (phase "b"), matched to its end by
        (cat, id) — one per ticket, spanning queue + service time."""
        if not self.enabled:
            return
        self._emit({"ph": "b", "name": name, "cat": cat, "id": id,
                    "tid": tid, "ts": self.clock() if ts is None else ts,
                    "args": args or {}})

    def async_end(self, name: str, id: int, *, ts: float | None = None,
                  cat: str = "ticket", tid: str = "main",
                  args: dict | None = None) -> None:
        """Close the async span opened with the same (cat, id)."""
        if not self.enabled:
            return
        self._emit({"ph": "e", "name": name, "cat": cat, "id": id,
                    "tid": tid, "ts": self.clock() if ts is None else ts,
                    "args": args or {}})

    def to_chrome(self) -> dict:
        """The buffer as a Chrome trace-event JSON object.

        Timestamps are shifted so the trace starts near zero and scaled
        to microseconds; events are stably sorted by (ts, begin-first)
        so viewers see well-nested spans.
        """
        if self.events:
            t_base = min(e["ts"] for e in self.events)
        else:
            t_base = 0.0
        order = {"b": 0, "X": 1, "i": 2, "e": 3}
        events = []
        for e in sorted(self.events,
                        key=lambda e: (e["ts"], order.get(e["ph"], 1))):
            out = dict(e)
            out["ts"] = (e["ts"] - t_base) * _US
            if "dur" in out:
                out["dur"] = e["dur"] * _US
            out["pid"] = 1
            events.append(out)
        return {"traceEvents": events, "displayTimeUnit": "ms",
                "otherData": {"dropped": self.dropped}}

    def dump(self, path: str) -> None:
        """Write `to_chrome()` as JSON to `path`."""
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f, indent=1)

    def clear(self) -> None:
        """Drop all buffered events and the dropped-event count."""
        self.events.clear()
        self.dropped = 0
