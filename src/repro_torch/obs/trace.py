"""Chrome-trace / Perfetto export of a timed run.

`export_trace(exp, path)` turns an experiment that ran with the event
clock (`World(timing=...)`) and telemetry (`node_compute`, plus
`edge_trigger` for transfer spans) into a ``trace.json`` in the Chrome
trace-event format — load it in chrome://tracing or https://ui.perfetto.dev:

  * pid 0, one tid per NODE: a complete ("X") span per round covering that
    node's realized local training (`ts` = the round's absolute start on
    the simulated clock, `dur` = its realized compute seconds — stragglers
    render as the long lanes they are);
  * pid 1, one tid per directed EDGE: a span per FIRED payload, starting
    when the sender finishes computing and lasting the edge's transfer
    time, annotated with the EXACT bytes on wire and — under
    `Schedule(deadline=...)` — whether it landed before the deadline.

The span bytes sum exactly to `RoundMetrics.bytes_on_wire` (pinned in
tests/test_torch_obs.py): both are payload_bytes × the same fired-gate
counts, multiplied outside fp32.  Times are seconds on the SIMULATED clock,
written in the format's microseconds.  The exporter reads host data only:
the channel history is numpy already, and the clock's per-edge transfer
times are read back from the experiment's device once.
"""
from __future__ import annotations

import json
from typing import Optional

import numpy as np


def _require(cond, msg):
    if not cond:
        raise ValueError(msg)


def build_trace(exp) -> dict:
    """The trace dict for `exp` (see module docstring).  Needs a completed
    run with `World(timing=...)` and a telemetry selection containing
    `node_compute` (edge transfer spans additionally need
    `edge_trigger`)."""
    _require(exp.bound_timing is not None,
             "trace export prices spans on the simulated clock; run with "
             "World(timing=repro_torch.timing.Timing(...))")
    obs = exp.bound_obs
    _require(obs is not None,
             "trace export reads telemetry channels; run with "
             "World(telemetry=repro_torch.obs.Telemetry(...))")
    _require("node_compute" in obs.channels,
             "trace export needs the 'node_compute' channel for the "
             "train spans (channels='auto' selects it with timing on)")
    _require(len(exp.obs_history) > 0,
             "no rounds recorded yet; call run() before export_trace")

    hist = exp.obs_history
    rounds = len(hist)
    n = obs.n
    sim = list(exp.sim_time_history)
    _require(len(sim) == rounds,
             "sim_time_history and telemetry history disagree")
    starts = np.asarray([0.0] + sim[:-1])

    cum_secs = np.stack([np.asarray(s["node_secs"]) for s in hist])
    secs = np.diff(cum_secs, axis=0, prepend=np.zeros((1, n)))
    steps = None
    if "node_steps" in obs.channels:
        cum_steps = np.stack([np.asarray(s["node_steps"]) for s in hist])
        steps = np.diff(cum_steps, axis=0, prepend=np.zeros((1, n)))

    events = [
        {"ph": "M", "pid": 0, "name": "process_name",
         "args": {"name": "nodes (local training)"}},
    ]
    for i in range(n):
        events.append({"ph": "M", "pid": 0, "tid": i, "name": "thread_name",
                       "args": {"name": f"node {i}"}})

    def us(t):
        return float(t) * 1e6

    for r in range(rounds):
        for i in range(n):
            if secs[r, i] <= 0:
                continue  # dead or zero-budget node: no span
            args = {"round": r}
            if steps is not None:
                args["steps"] = int(round(float(steps[r, i])))
            events.append({"ph": "X", "pid": 0, "tid": i,
                           "name": f"train r{r}", "ts": us(starts[r]),
                           "dur": us(secs[r, i]), "args": args})

    if "edge_trigger" in obs.channels and exp.transport is not None:
        src, dst = obs.edge_src, obs.edge_dst
        payload = float(exp.transport.payload_bytes)
        transfer = exp.bound_timing.transfer_e.detach().cpu().numpy() \
            .astype(np.float64)
        deadline = exp.deadline
        cum_sent = np.stack([obs._edge(s["edge_sent"]) for s in hist])
        fired = np.diff(cum_sent, axis=0,
                        prepend=np.zeros((1, obs.num_directed)))
        events.append({"ph": "M", "pid": 1, "name": "process_name",
                       "args": {"name": "edges (payload transfers)"}})
        for e in range(obs.num_directed):
            events.append({"ph": "M", "pid": 1, "tid": e,
                           "name": "thread_name",
                           "args": {"name": f"{src[e]}->{dst[e]}"}})
        for r in range(rounds):
            for e in np.nonzero(fired[r] > 0)[0]:
                t_send = secs[r, src[e]]
                landing = t_send + transfer[e]
                args = {"round": r,
                        "bytes": payload * float(fired[r, e]),
                        "src": int(src[e]), "dst": int(dst[e])}
                if deadline is not None:
                    args["deadline_s"] = float(deadline)
                    args["arrived"] = bool(landing <= deadline)
                events.append({"ph": "X", "pid": 1, "tid": int(e),
                               "name": f"{src[e]}->{dst[e]} r{r}",
                               "ts": us(starts[r] + t_send),
                               "dur": us(transfer[e]), "args": args})

    return {"traceEvents": events, "displayTimeUnit": "ms"}


def export_trace(exp, path: Optional[str] = None) -> dict:
    """Build the trace and (optionally) write it to `path`; returns the
    trace dict either way.  On the pod backend only rank 0 writes (every
    rank holds the same histories)."""
    trace = build_trace(exp)
    if path is not None and getattr(exp, "is_writer", True):
        with open(path, "w") as f:
            json.dump(trace, f)
    return trace
