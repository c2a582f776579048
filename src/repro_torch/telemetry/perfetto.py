"""Chrome/Perfetto trace exporter for the serving telemetry collector (a
copy of the reference's ``telemetry/perfetto.py``).

Writes the Trace Event Format JSON (``{"traceEvents": [...]}``) that
``ui.perfetto.dev`` / ``chrome://tracing`` load directly:

* **pid 1 — "serving" process, one thread per slot.**  Each closed request
  span is a complete ("X") slice on its slot's track from admit to retire,
  with a nested "decode" slice from first token to retire; prefill-chunk
  completions and the first token are instant ("i") events.  Timestamps are
  wall-clock, rebased to the collector's first stamp.
* **pid 1, tid 1000 — scheduler counter tracks.**  "C" events per step:
  active slots, decoding slots, waiting queue, engine backlog.
* **pid 100+tier — one "memctl tier N" process per memory tier, one thread
  per lane.**  Lane busy intervals are "X" slices (engine-clock timestamps,
  cycles converted to ns at the tier's clock rate), and per-tick counter
  tracks carry serviced bytes/step and queue depth.

The two clock domains (host wall vs modeled engine) live in SEPARATE
processes, so Perfetto renders both without pretending they share an epoch;
each process's metadata names its domain.

:func:`validate_trace` is the schema gate ``chip_smoke.py`` and the tests
run: phases from the known set, pid/tid/ts present and numeric, "X"
durations non-negative, counter args numeric, and the expected track
metadata present.
"""

from __future__ import annotations

import json
from typing import List

#: trace-event phases the exporter emits (validate_trace's whitelist)
VALID_PHASES = {"B", "E", "X", "C", "i", "I", "M"}

SCHED_PID = 1
COUNTER_TID = 1000
MEMCTL_PID_BASE = 100
WEIGHT_TID = 999  # per-tier weight-stream instants (above the lane tids)


def _us(ns: float) -> float:
    return ns / 1000.0


def build_trace_events(collector, clock_ghz: float = 2.0) -> List[dict]:
    """Collector contents -> Trace Event Format event list."""
    if not collector.enabled:
        raise ValueError(
            "cannot export a Perfetto trace from a disabled collector — "
            "enable telemetry (EngineConfig.telemetry=TelemetryConfig()) "
            "before serving"
        )
    wall0 = collector.wall_epoch_ns
    ev: List[dict] = [
        {"ph": "M", "pid": SCHED_PID, "tid": 0, "name": "process_name",
         "args": {"name": "serving (wall clock)"}},
    ]
    slots_seen = set()
    for sp in collector.closed_spans + list(collector.open_spans.values()):
        if sp.admit is None or sp.retire is None:
            continue  # open/unadmitted spans have no closed slice to draw
        tid = max(0, sp.slot)
        if tid not in slots_seen:
            slots_seen.add(tid)
            ev.append({"ph": "M", "pid": SCHED_PID, "tid": tid,
                       "name": "thread_name",
                       "args": {"name": f"slot {tid}"}})
        t0 = _us(sp.admit.wall_ns - wall0)
        t1 = _us(sp.retire.wall_ns - wall0)
        ev.append({
            "ph": "X", "pid": SCHED_PID, "tid": tid, "cat": "request",
            "name": f"req {sp.rid}", "ts": t0, "dur": max(0.0, t1 - t0),
            "args": {
                "rid": sp.rid, "prompt_tokens": sp.prompt_tokens,
                "new_tokens": sp.new_tokens, "truncated": sp.truncated,
                "ttft_wall_ns": sp.ttft_wall_ns(),
                "ttft_engine_ns": sp.ttft_engine_ns(),
                "device_bytes_read": sp.device_bytes_read,
                "fetches": sp.fetches,
            },
        })
        for stamp, start, end, final in sp.prefill_chunks:
            ev.append({
                "ph": "i", "pid": SCHED_PID, "tid": tid, "s": "t",
                "cat": "prefill", "name": f"chunk [{start},{end})",
                "ts": _us(stamp.wall_ns - wall0),
                "args": {"rid": sp.rid, "final": final},
            })
        if sp.first_token is not None:
            ft = _us(sp.first_token.wall_ns - wall0)
            ev.append({
                "ph": "i", "pid": SCHED_PID, "tid": tid, "s": "t",
                "cat": "request", "name": "first_token", "ts": ft,
                "args": {"rid": sp.rid},
            })
            ev.append({
                "ph": "X", "pid": SCHED_PID, "tid": tid, "cat": "decode",
                "name": "decode", "ts": ft, "dur": max(0.0, t1 - ft),
                "args": {"rid": sp.rid, "tokens": sp.new_tokens},
            })
    # scheduler counter tracks (wall clock)
    if collector.step_events:
        ev.append({"ph": "M", "pid": SCHED_PID, "tid": COUNTER_TID,
                   "name": "thread_name", "args": {"name": "scheduler"}})
    for rec in collector.step_events:
        ts = _us(rec["wall_ns"] - wall0)
        for name in ("active", "decoding", "waiting", "backlog"):
            if name in rec:
                ev.append({"ph": "C", "pid": SCHED_PID, "tid": COUNTER_TID,
                           "name": name, "ts": ts,
                           "args": {name: rec[name]}})
    # memctl tier processes (engine clock)
    weight_events = getattr(collector, "weight_events", [])
    tiers = sorted({t for t, *_ in collector.lane_blocks}
                   | {r["tier"] for r in collector.engine_steps}
                   | {t for t, *_ in weight_events})
    lanes_seen = set()
    for tier in tiers:
        ev.append({"ph": "M", "pid": MEMCTL_PID_BASE + tier, "tid": 0,
                   "name": "process_name",
                   "args": {"name": f"memctl tier {tier} (engine clock)"}})
    for tier, lane, c0, c1, nbytes in collector.lane_blocks:
        pid = MEMCTL_PID_BASE + tier
        if (tier, lane) not in lanes_seen:
            lanes_seen.add((tier, lane))
            ev.append({"ph": "M", "pid": pid, "tid": lane,
                       "name": "thread_name",
                       "args": {"name": f"lane {lane}"}})
        ts = _us(c0 / clock_ghz)
        dur = _us(max(0, c1 - c0) / clock_ghz)
        ev.append({"ph": "X", "pid": pid, "tid": lane, "cat": "lane",
                   "name": f"block {nbytes}B", "ts": ts, "dur": dur,
                   "args": {"nbytes": nbytes, "cycles": c1 - c0}})
    # weight-stream layer fetches: instants on their own thread of each
    # memctl tier process, stamped at the engine service cycle so they sit
    # on the lane timeline next to the KV blocks they contended with
    wtiers_seen = set()
    for tier, layer, pass_idx, cycle, logical, physical in weight_events:
        pid = MEMCTL_PID_BASE + tier
        if tier not in wtiers_seen:
            wtiers_seen.add(tier)
            ev.append({"ph": "M", "pid": pid, "tid": WEIGHT_TID,
                       "name": "thread_name",
                       "args": {"name": "weight stream"}})
        ev.append({"ph": "i", "pid": pid, "tid": WEIGHT_TID, "s": "t",
                   "cat": "weights", "name": f"L{layer} pass {pass_idx}",
                   "ts": _us(cycle / clock_ghz),
                   "args": {"layer": layer, "pass": pass_idx,
                            "logical_bytes": logical,
                            "physical_bytes": physical}})
    for rec in collector.engine_steps:
        pid = MEMCTL_PID_BASE + rec["tier"]
        ts = _us(rec.get("window_start_cycle", 0) / clock_ghz)
        for name in ("serviced_bytes", "queue_depth", "deferred_jobs"):
            if name in rec:
                ev.append({"ph": "C", "pid": pid, "tid": COUNTER_TID,
                           "name": name, "ts": ts,
                           "args": {name: rec[name]}})
    return ev


def write_perfetto_trace(collector, path: str,
                         clock_ghz: float = 2.0) -> dict:
    """Write the collector's trace to ``path`` (Perfetto-loadable JSON) and
    return the trace dict (already schema-validated)."""
    trace = {
        "traceEvents": build_trace_events(collector, clock_ghz=clock_ghz),
        "displayTimeUnit": "ms",
        "otherData": {
            "generator": "repro_torch.telemetry",
            "clock_domains": "pid 1 = host wall clock; "
                             "pid >= 100 = modeled memctl engine clock",
        },
    }
    validate_trace(trace)
    with open(path, "w") as fh:
        json.dump(trace, fh)
    return trace


def validate_trace(trace) -> dict:
    """Schema-validate a Perfetto/Chrome trace (dict, JSON string, or file
    path).  Raises ``ValueError`` naming the first offending event; returns
    summary counts (events per phase, tracks seen) on success — the CI
    smoke artifact gate and the unit tests both run exactly this."""
    if isinstance(trace, str):
        if trace.lstrip().startswith("{"):
            trace = json.loads(trace)
        else:
            with open(trace) as fh:
                trace = json.load(fh)
    if not isinstance(trace, dict) or "traceEvents" not in trace:
        raise ValueError("trace must be a dict with a 'traceEvents' list")
    events = trace["traceEvents"]
    if not isinstance(events, list) or not events:
        raise ValueError("traceEvents must be a non-empty list")
    phases: dict = {}
    tracks = set()
    for i, e in enumerate(events):
        ph = e.get("ph")
        if ph not in VALID_PHASES:
            raise ValueError(f"event {i}: invalid phase {ph!r}")
        if not isinstance(e.get("pid"), int) or not isinstance(
                e.get("tid"), int):
            raise ValueError(f"event {i}: pid/tid must be integers, got "
                             f"pid={e.get('pid')!r} tid={e.get('tid')!r}")
        if ph != "M":
            ts = e.get("ts")
            if not isinstance(ts, (int, float)):
                raise ValueError(f"event {i}: missing numeric ts")
            if ts < 0:
                raise ValueError(f"event {i}: negative ts {ts}")
        if ph == "X":
            dur = e.get("dur")
            if not isinstance(dur, (int, float)) or dur < 0:
                raise ValueError(f"event {i}: X event needs dur >= 0, "
                                 f"got {dur!r}")
        if ph == "C":
            args = e.get("args", {})
            if not args or not all(
                    isinstance(v, (int, float)) for v in args.values()):
                raise ValueError(f"event {i}: counter args must be numeric")
        if ph == "M" and e.get("name") not in ("process_name",
                                               "thread_name"):
            raise ValueError(f"event {i}: unknown metadata {e.get('name')!r}")
        phases[ph] = phases.get(ph, 0) + 1
        tracks.add((e["pid"], e["tid"]))
    names = {e.get("args", {}).get("name") for e in events
             if e.get("ph") == "M"}
    if not any(isinstance(n, str) and n.startswith("slot") for n in names):
        raise ValueError("trace has no per-slot request track")
    return {"events": len(events), "phases": phases,
            "tracks": len(tracks),
            "has_lane_track": any(isinstance(n, str) and n.startswith("lane")
                                  for n in names),
            "has_counters": phases.get("C", 0) > 0}
