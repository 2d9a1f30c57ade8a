"""Unified telemetry: a metrics registry, span tracing, and a flight
recorder — the observability substrate every runtime layer reports into.

The reproduction's telemetry used to be a patchwork of ad-hoc dicts
(``ServeEngine.kv_stats()/spec_stats()``, ``ClusterRouter.stats()``,
``KVCacheManager.stats()``) with no time dimension and no export format.
This module gives the stack one spine, in three layers:

``MetricsRegistry``
    Labeled counters / gauges / histograms with Prometheus text
    exposition (``to_prometheus()``) and a JSON dump (``to_dict()``).
    Gauges may be *function-backed* (``set_function``): the child reads
    live state (pool occupancy, scheduler counters) at export time, so
    hot paths never double-book — the legacy stats dicts are now thin
    views over registry values, which is what keeps their schemas from
    drifting (gated by ``tests/test_telemetry.py``).

``TraceRecorder``
    Structured events in Chrome trace-event form (open
    ``chrome://tracing`` or https://ui.perfetto.dev on the JSON):
    per-request lifecycle spans (QUEUED → PREFILL → DECODE, with
    PREEMPTED / REPLAY sub-spans), per-tick engine counter tracks (live
    slots, queue depth, free pages, draft acceptance, step-cache hits),
    and router instants (heartbeat misses, LOST/fence, placement,
    straggler route-around, brown-out).  ``pid`` is the replica id
    (router events use ``ROUTER_PID``), ``tid`` the request id, so
    Perfetto renders one track per replica and one row per request.
    **Invariant — span pairing**: every ``begin_span`` is closed by
    exactly one matching ``end_span`` on the same ``(pid, tid)`` track,
    in LIFO order within the track; open spans are tracked per
    ``(pid, tid)`` and ``end_all(pid)`` closes a fenced replica's spans
    so chaos never leaks an orphan.  ``validate_chrome_trace`` reports
    any ``(pid, tid)`` stack still holding an open begin, and the
    ``python -m repro_torch.runtime.telemetry`` CLI fails on them (unless
    ``--allow-unbalanced``, for partial dumps) — an emitted trace that
    fails it is a bug in the emitter.  An optional ``limit``
    turns the event store into a bounded ring buffer (``dropped``
    counts evictions; span balance is only guaranteed for spans whose
    begin survived the ring).

``Telemetry``
    The facade the engine/router/launcher bind to: always carries a
    real registry (cheap), and either a live ``TraceRecorder`` or the
    shared ``NULL_TRACE`` no-op — the null-sink fast path that makes
    disabled tracing cost near zero (gated at ≤2% tokens/s overhead
    *with tracing fully on* in ``benchmarks/serve_throughput.py``).
    ``dump_flight(reason)`` writes the last ``flight`` events plus a
    full metrics snapshot to ``flight_dir`` — ``ClusterRouter`` calls
    it automatically on fence/retry-exhaustion, so every chaos anomaly
    ships its own post-mortem.

``python -m repro_torch.runtime.telemetry <trace.json>`` validates an emitted
trace (shape + span balance); ``scripts/ci.sh`` runs it over the
launcher's ``--trace-out`` output.  See docs/observability.md.
"""
from __future__ import annotations

import json
import os
import time
from collections import deque
from typing import Callable, Iterable, Optional

__all__ = ["MetricsRegistry", "TraceRecorder", "NullTrace", "NULL_TRACE",
           "Telemetry", "ROUTER_PID", "validate_chrome_trace"]

ROUTER_PID = 10_000  # trace track for cluster-router events (pid space
#                      0..N-1 belongs to the engine replicas)

_DEFAULT_BUCKETS = (0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05,
                    0.1, 0.25, 0.5, 1.0, 2.5, 5.0, 10.0)


def _escape(v: str) -> str:
    return (str(v).replace("\\", r"\\").replace("\n", r"\n")
            .replace('"', r'\"'))


def _fmt_labels(labels: dict) -> str:
    if not labels:
        return ""
    inner = ",".join(f'{k}="{_escape(v)}"'
                     for k, v in sorted(labels.items()))
    return "{" + inner + "}"


class _Child:
    """One (metric, label-set) series.  Counters/gauges store a float;
    a gauge may instead be function-backed (``set_function``), reading
    live state at export time."""

    __slots__ = ("value", "_fn")

    def __init__(self):
        self.value = 0.0
        self._fn: Optional[Callable[[], float]] = None

    def inc(self, v: float = 1.0) -> None:
        self.value += v

    def dec(self, v: float = 1.0) -> None:
        self.value -= v

    def set(self, v: float) -> None:
        self.value = float(v)

    def set_function(self, fn: Callable[[], float]) -> None:
        self._fn = fn

    def get(self) -> float:
        return float(self._fn()) if self._fn is not None else self.value


class _HistChild:
    """One histogram series: cumulative buckets + sum + count."""

    __slots__ = ("buckets", "counts", "sum", "count")

    def __init__(self, buckets):
        self.buckets = tuple(buckets)
        self.counts = [0] * len(self.buckets)
        self.sum = 0.0
        self.count = 0

    def observe(self, v: float) -> None:
        v = float(v)
        self.sum += v
        self.count += 1
        for i, le in enumerate(self.buckets):
            if v <= le:
                self.counts[i] += 1
                break  # per-bucket counts; get() accumulates

    def get(self) -> dict:
        return {"buckets": {str(le): int(sum(self.counts[:i + 1]))
                            for i, le in enumerate(self.buckets)},
                "sum": self.sum, "count": self.count}


class MetricFamily:
    """A named metric plus its labeled children.  ``labels(**kv)``
    returns (creating on first use) the child for one label set; the
    unlabeled child is ``labels()``."""

    def __init__(self, name: str, help: str, type: str,
                 labelnames: Iterable[str] = (), buckets=None):
        self.name = name
        self.help = help
        self.type = type
        self.labelnames = tuple(labelnames)
        self.buckets = tuple(buckets or _DEFAULT_BUCKETS)
        self._children: dict[tuple, object] = {}

    def _key(self, kv: dict) -> tuple:
        if set(kv) != set(self.labelnames):
            raise ValueError(
                f"metric {self.name}: labels {sorted(kv)} != declared "
                f"{sorted(self.labelnames)}")
        return tuple(str(kv[k]) for k in self.labelnames)

    def labels(self, **kv):
        key = self._key(kv)
        child = self._children.get(key)
        if child is None:
            child = (_HistChild(self.buckets) if self.type == "histogram"
                     else _Child())
            self._children[key] = child
        return child

    def samples(self):
        """Yield (labels_dict, child) pairs, label-sorted."""
        for key in sorted(self._children):
            yield (dict(zip(self.labelnames, key)), self._children[key])


class MetricsRegistry:
    """Process-local registry of labeled counters/gauges/histograms.

    Re-registering an existing name returns the existing family (so N
    engine replicas binding into one shared registry each get their own
    ``replica=...``-labeled children of the same families)."""

    def __init__(self):
        self._families: dict[str, MetricFamily] = {}

    def _register(self, name, help, type, labelnames, buckets=None):
        fam = self._families.get(name)
        if fam is None:
            fam = MetricFamily(name, help, type, labelnames, buckets)
            self._families[name] = fam
        elif fam.type != type:
            raise ValueError(f"metric {name} already registered as "
                             f"{fam.type}, not {type}")
        return fam

    def counter(self, name: str, help: str = "",
                labelnames: Iterable[str] = ()) -> MetricFamily:
        return self._register(name, help, "counter", labelnames)

    def gauge(self, name: str, help: str = "",
              labelnames: Iterable[str] = ()) -> MetricFamily:
        return self._register(name, help, "gauge", labelnames)

    def histogram(self, name: str, help: str = "",
                  labelnames: Iterable[str] = (),
                  buckets=None) -> MetricFamily:
        return self._register(name, help, "histogram", labelnames, buckets)

    def names(self) -> list[str]:
        return sorted(self._families)

    def value(self, name: str, **labels) -> float:
        """Read one series' current value (resolving function-backed
        gauges) — what the legacy stats dicts are built from."""
        child = self._families[name].labels(**labels)
        v = child.get()
        return v if isinstance(v, (int, float)) else v  # hist: dict

    # ------------------------------------------------------------ export
    def to_dict(self) -> dict:
        """JSON-dumpable snapshot: {name: {type, help, series: [...]}}."""
        out = {}
        for name in sorted(self._families):
            fam = self._families[name]
            series = [{"labels": labels, "value": child.get()}
                      for labels, child in fam.samples()]
            out[name] = {"type": fam.type, "help": fam.help,
                         "series": series}
        return out

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (0.0.4)."""
        lines = []
        for name in sorted(self._families):
            fam = self._families[name]
            if fam.help:
                lines.append(f"# HELP {name} {_escape(fam.help)}")
            lines.append(f"# TYPE {name} {fam.type}")
            for labels, child in fam.samples():
                if fam.type == "histogram":
                    h = child.get()
                    for le, cum in h["buckets"].items():
                        lb = _fmt_labels({**labels, "le": le})
                        lines.append(f"{name}_bucket{lb} {cum}")
                    lb = _fmt_labels({**labels, "le": "+Inf"})
                    lines.append(f"{name}_bucket{lb} {h['count']}")
                    lines.append(
                        f"{name}_sum{_fmt_labels(labels)} {h['sum']:g}")
                    lines.append(
                        f"{name}_count{_fmt_labels(labels)} {h['count']}")
                else:
                    lines.append(
                        f"{name}{_fmt_labels(labels)} {child.get():g}")
        return "\n".join(lines) + "\n"

    def write(self, path: str) -> str:
        """Write the snapshot: ``.prom``/``.txt`` → Prometheus text,
        anything else → JSON."""
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            if path.endswith((".prom", ".txt")):
                f.write(self.to_prometheus())
            else:
                json.dump(self.to_dict(), f, indent=1)
        return path


# ------------------------------------------------------------------ tracing
class TraceRecorder:
    """Chrome trace-event recorder (ph: B/E spans, i instants, C
    counters, M metadata), microsecond timestamps from a shared t0.

    ``limit`` bounds the event store as a ring buffer (the flight-
    recorder memory cap); open-span bookkeeping is separate, so span
    balance survives ring eviction."""

    enabled = True

    def __init__(self, limit: Optional[int] = None):
        self._t0 = time.perf_counter()
        self.events: deque = deque(maxlen=limit)
        self.total = 0   # events ever recorded (ring drops: total - len)
        self._open: dict[tuple, list] = {}  # (pid, tid) -> [names]

    @property
    def dropped(self) -> int:
        return self.total - len(self.events)

    def now_us(self) -> float:
        return (time.perf_counter() - self._t0) * 1e6

    def _push(self, ev: dict) -> None:
        self.events.append(ev)
        self.total += 1

    # ------------------------------------------------------------- spans
    def begin(self, pid: int, tid: int, name: str, **args) -> None:
        self._open.setdefault((pid, tid), []).append(name)
        ev = {"ph": "B", "pid": pid, "tid": tid, "name": name,
              "ts": self.now_us()}
        if args:
            ev["args"] = args
        self._push(ev)

    def end(self, pid: int, tid: int, **args) -> None:
        stack = self._open.get((pid, tid))
        assert stack, f"end() without begin() on (pid={pid}, tid={tid})"
        stack.pop()
        if not stack:
            del self._open[(pid, tid)]
        ev = {"ph": "E", "pid": pid, "tid": tid, "ts": self.now_us()}
        if args:
            ev["args"] = args
        self._push(ev)

    def end_if_open(self, pid: int, tid: int, **args) -> bool:
        if (pid, tid) in self._open:
            self.end(pid, tid, **args)
            return True
        return False

    def end_all(self, pid: int, **args) -> int:
        """Close every open span on ``pid`` (innermost first) — a fenced
        replica's streams end here, never dangle.  Returns spans
        closed."""
        n = 0
        for (p, tid) in [k for k in self._open if k[0] == pid]:
            while self.end_if_open(p, tid, **args):
                n += 1
        return n

    def open_spans(self) -> dict:
        """{(pid, tid): [open span names]} — empty means balanced."""
        return {k: list(v) for k, v in self._open.items()}

    # ---------------------------------------------------- instants etc.
    def instant(self, pid: int, name: str, tid: int = 0, **args) -> None:
        ev = {"ph": "i", "pid": pid, "tid": tid, "name": name, "s": "p",
              "ts": self.now_us()}
        if args:
            ev["args"] = args
        self._push(ev)

    def counter(self, pid: int, name: str, values: dict) -> None:
        self._push({"ph": "C", "pid": pid, "tid": 0, "name": name,
                    "ts": self.now_us(), "args": dict(values)})

    def set_process_name(self, pid: int, name: str) -> None:
        self._push({"ph": "M", "pid": pid, "tid": 0,
                    "name": "process_name", "ts": 0,
                    "args": {"name": name}})

    # ------------------------------------------------------------ export
    def tail(self, n: int) -> list[dict]:
        if n <= 0 or n >= len(self.events):
            return list(self.events)
        return list(self.events)[-n:]

    def to_chrome(self, events: Optional[list] = None) -> dict:
        return {"traceEvents": (list(self.events) if events is None
                                else list(events)),
                "displayTimeUnit": "ms"}

    def write(self, path: str) -> str:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        with open(path, "w") as f:
            json.dump(self.to_chrome(), f)
        return path


class NullTrace:
    """No-op sink with ``TraceRecorder``'s surface: the fast path when
    tracing is off.  Every hot-path call site guards on ``.enabled``
    before building args, so disabled telemetry costs one attribute
    read per event site."""

    enabled = False
    events: tuple = ()
    total = 0
    dropped = 0

    def begin(self, *a, **kw):
        pass

    def end(self, *a, **kw):
        pass

    def end_if_open(self, *a, **kw):
        return False

    def end_all(self, *a, **kw):
        return 0

    def instant(self, *a, **kw):
        pass

    def counter(self, *a, **kw):
        pass

    def set_process_name(self, *a, **kw):
        pass

    def open_spans(self):
        return {}

    def tail(self, n):
        return []

    def to_chrome(self, events=None):
        return {"traceEvents": [], "displayTimeUnit": "ms"}


NULL_TRACE = NullTrace()


# ------------------------------------------------------------------ facade
class Telemetry:
    """What the engine / router / launcher bind to.

    * ``registry`` is always real — metrics are cheap and every legacy
      stats dict reads from them.
    * ``trace`` is a live ``TraceRecorder`` when ``trace=True`` (with
      ``ring`` bounding the event store), else the shared no-op
      ``NULL_TRACE``.
    * ``flight`` > 0 arms the flight recorder: ``dump_flight(reason)``
      writes the last ``flight`` trace events + a metrics snapshot to
      ``flight_dir`` (``ClusterRouter`` calls it on fence / retry
      exhaustion).
    """

    def __init__(self, *, trace: bool = False, flight: int = 0,
                 flight_dir: str = "artifacts", ring: Optional[int] = None,
                 registry: Optional[MetricsRegistry] = None):
        self.registry = registry if registry is not None else \
            MetricsRegistry()
        self.trace = TraceRecorder(limit=ring) if (trace or flight) \
            else NULL_TRACE
        self.flight = int(flight)
        self.flight_dir = flight_dir
        self.flight_dumps: list[str] = []

    # ------------------------------------------------- request lifecycle
    def req_transition(self, pid: int, req_id: int, state: str,
                       **args) -> None:
        """Close the request's open span (if any) and open ``state`` —
        one call per lifecycle edge keeps B/E balanced by
        construction."""
        tr = self.trace
        if not tr.enabled:
            return
        tr.end_if_open(pid, req_id)
        tr.begin(pid, req_id, state, req=req_id, **args)

    def req_end(self, pid: int, req_id: int, **args) -> None:
        tr = self.trace
        if tr.enabled:
            tr.end_if_open(pid, req_id, **args)

    # ----------------------------------------------------------- flight
    def dump_flight(self, reason: str, extra: Optional[dict] = None
                    ) -> Optional[str]:
        """Write the post-mortem: last ``flight`` trace events + full
        metrics snapshot.  Returns the path (None when disarmed)."""
        if self.flight <= 0:
            return None
        os.makedirs(self.flight_dir, exist_ok=True)
        seq = len(self.flight_dumps)
        safe = "".join(c if c.isalnum() or c in "-_" else "-"
                       for c in reason)
        path = os.path.join(self.flight_dir, f"flight_{seq:03d}_{safe}.json")
        payload = {
            "reason": reason,
            "unix_time": time.time(),
            "events_recorded": self.trace.total,
            "events_dropped": self.trace.dropped,
            "open_spans": {f"{pid}/{tid}": names for (pid, tid), names
                           in self.trace.open_spans().items()},
            "events": self.trace.tail(self.flight),
            "metrics": self.registry.to_dict(),
        }
        if extra:
            payload.update(extra)
        with open(path, "w") as f:
            json.dump(payload, f, indent=1)
        self.flight_dumps.append(path)
        return path

    # ------------------------------------------------------------ export
    def write_trace(self, path: str) -> str:
        if not self.trace.enabled:
            raise ValueError("tracing is disabled (Telemetry(trace=True))")
        return self.trace.write(path)

    def write_metrics(self, path: str) -> str:
        return self.registry.write(path)


# -------------------------------------------------------------- validation
def validate_chrome_trace(trace) -> dict:
    """Validate a Chrome trace-event JSON (path, dict, or event list).

    Raises ``ValueError`` on malformed input; returns a summary dict
    (event/span/instant/counter counts, pids, unbalanced span stacks).
    A trace cut from a ring buffer may open with orphan "E" events —
    those are tolerated and counted, but a "B" left open is not.
    """
    if isinstance(trace, str):
        with open(trace) as f:
            trace = json.load(f)
    if isinstance(trace, dict):
        events = trace.get("traceEvents")
        if not isinstance(events, list):
            raise ValueError("trace JSON must carry a 'traceEvents' list")
    elif isinstance(trace, list):
        events = trace
    else:
        raise ValueError(f"not a trace: {type(trace).__name__}")
    counts = {"B": 0, "E": 0, "i": 0, "C": 0, "M": 0}
    stacks: dict[tuple, list] = {}
    orphan_ends = 0
    pids = set()
    for i, ev in enumerate(events):
        if not isinstance(ev, dict):
            raise ValueError(f"event #{i} is not an object")
        ph = ev.get("ph")
        if ph not in counts:
            raise ValueError(f"event #{i}: unknown phase {ph!r}")
        for field in ("pid", "tid", "ts"):
            if not isinstance(ev.get(field), (int, float)):
                raise ValueError(f"event #{i} ({ph}): missing numeric "
                                 f"{field!r}")
        if ph != "E" and not isinstance(ev.get("name"), str):
            raise ValueError(f"event #{i} ({ph}): missing 'name'")
        counts[ph] += 1
        pids.add(ev["pid"])
        key = (ev["pid"], ev["tid"])
        if ph == "B":
            stacks.setdefault(key, []).append(ev["name"])
        elif ph == "E":
            if stacks.get(key):
                stacks[key].pop()
            else:
                orphan_ends += 1  # ring-buffer cut: B evicted, E kept
    unbalanced = {f"{pid}/{tid}": names
                  for (pid, tid), names in stacks.items() if names}
    return {"events": len(events), "counts": counts,
            "pids": sorted(pids), "orphan_ends": orphan_ends,
            "unbalanced": unbalanced, "balanced": not unbalanced}


def main(argv=None) -> int:
    import argparse

    ap = argparse.ArgumentParser(
        description="validate a Chrome trace-event JSON emitted via "
                    "--trace-out (shape + span balance)")
    ap.add_argument("trace", help="path to the trace JSON")
    ap.add_argument("--allow-unbalanced", action="store_true",
                    help="do not fail on open spans (partial dumps)")
    args = ap.parse_args(argv)
    try:
        summary = validate_chrome_trace(args.trace)
    except (ValueError, OSError, json.JSONDecodeError) as e:
        print(f"INVALID trace {args.trace}: {e}")
        return 1
    c = summary["counts"]
    print(f"trace {args.trace}: {summary['events']} events "
          f"({c['B']} span begins, {c['i']} instants, {c['C']} counter "
          f"samples) across pids {summary['pids']}")
    if summary["unbalanced"] and not args.allow_unbalanced:
        print(f"UNBALANCED spans: {summary['unbalanced']}")
        return 1
    print("trace OK" + ("" if summary["balanced"]
                        else " (unbalanced spans allowed)"))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
