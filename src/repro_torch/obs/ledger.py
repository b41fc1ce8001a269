"""The run ledger: a structured, schema-validated JSONL record of a run.

Three record kinds, one JSON object per line:

  * ``manifest`` — written once per ledger: config (method / backend /
    layout / wire / schedule), seed, the selected telemetry channels, the
    environment (python / torch / numpy versions, platform, device type
    and count), payload bytes, and — when per-edge channels are selected
    and the graph is small enough — the canonical directed-edge endpoint
    lists so edge channels can be joined back to the graph;
  * ``round``    — one per eval round: the full RoundMetrics surface
    (per-node accuracy included) plus the materialized channel `detail`;
  * ``summary``  — one per `run()` call: wall seconds and rounds/sec (the
    schema's optional compile-time counters stay out: the port compiles no
    program).

Validation is hand-rolled against `SCHEMA` (stdlib-only — no jsonschema
dependency): required fields with type checks per kind, unknown kinds
rejected.  `validate_ledger(path)` re-validates a written file and returns
the per-kind counts.

This module also owns the engine's verbose round line: `format_round`
renders the text `Experiment.run(verbose=True)` prints, byte for byte the
JAX package's, and `log_round` emits it through stdlib `logging` (logger
``repro_torch.obs.round``, stdout handler attached on first use), so the
verbose output can be intercepted like any other logging stream.
"""
from __future__ import annotations

import json
import logging
import platform as _platform
import sys
from typing import Dict, Optional

import numpy as np

SCHEMA_VERSION = 1

# Required fields per record kind (name -> allowed types).  Optional
# fields are validated only when present.
SCHEMA = {
    "manifest": {
        "required": {
            "kind": str, "schema": int, "method": str, "backend": str,
            "layout": str, "wire": str, "mode": str, "rounds": int,
            "eval_every": int, "nodes": int, "num_directed": int,
            "seed": int, "channels": list, "env": dict,
        },
        "optional": {
            "deadline": (int, float, type(None)),
            "payload_bytes": (int, float, type(None)),
            "edges": dict,
        },
    },
    "round": {
        "required": {
            "kind": str, "round": int, "acc_mean": float, "acc_std": float,
            "loss_mean": float, "acc_per_node": list,
        },
        "optional": {
            "bytes_on_wire": (int, float), "triggered_frac": (int, float),
            "live_edge_frac": (int, float), "sim_time": (int, float),
            "arrived_frac": (int, float), "detail": dict,
        },
    },
    "summary": {
        "required": {
            "kind": str, "mode": str, "rounds": int, "wall_s": float,
            "rounds_per_sec": float,
        },
        "optional": {
            "cold_compile": bool, "compile_s": (int, float),
        },
    },
}

# edge lists above this size are omitted from the manifest (the ledger is
# a log, not a graph store; SparseTopology serializes the graph itself)
MANIFEST_EDGE_CAP = 32768


def _jsonable(v):
    """numpy scalars/arrays -> plain python, recursively."""
    if isinstance(v, dict):
        return {k: _jsonable(x) for k, x in v.items()}
    if isinstance(v, (list, tuple)):
        return [_jsonable(x) for x in v]
    if isinstance(v, np.ndarray):
        return v.tolist()
    if isinstance(v, (np.floating,)):
        return float(v)
    if isinstance(v, (np.integer,)):
        return int(v)
    if isinstance(v, (np.bool_,)):
        return bool(v)
    return v


def validate_record(rec: dict) -> dict:
    """Check one ledger record against SCHEMA; returns it (raises
    ValueError with the offending field otherwise)."""
    if not isinstance(rec, dict):
        raise ValueError(f"ledger record must be an object, got "
                         f"{type(rec).__name__}")
    kind = rec.get("kind")
    if kind not in SCHEMA:
        raise ValueError(f"unknown ledger record kind {kind!r}; "
                         f"expected one of {sorted(SCHEMA)}")
    spec = SCHEMA[kind]
    for field, types in spec["required"].items():
        if field not in rec:
            raise ValueError(f"{kind} record missing required field "
                             f"{field!r}")
        if not isinstance(rec[field], types):
            raise ValueError(
                f"{kind} record field {field!r} has type "
                f"{type(rec[field]).__name__}, expected "
                f"{getattr(types, '__name__', types)}")
    for field, types in spec["optional"].items():
        if field in rec and not isinstance(rec[field], types):
            raise ValueError(
                f"{kind} record field {field!r} has type "
                f"{type(rec[field]).__name__}")
    return rec


def validate_ledger(path: str) -> Dict[str, int]:
    """Validate every line of a written ledger; returns {kind: count}.
    The first record must be the manifest."""
    counts: Dict[str, int] = {}
    with open(path) as f:
        for i, line in enumerate(f):
            line = line.strip()
            if not line:
                continue
            try:
                rec = json.loads(line)
            except json.JSONDecodeError as e:
                raise ValueError(f"{path}:{i + 1}: not valid JSON: {e}")
            validate_record(rec)
            if i == 0 and rec["kind"] != "manifest":
                raise ValueError(f"{path}: first record must be the "
                                 f"manifest, got {rec['kind']!r}")
            counts[rec["kind"]] = counts.get(rec["kind"], 0) + 1
    if "manifest" not in counts:
        raise ValueError(f"{path}: empty ledger (no manifest)")
    return counts


def run_manifest(exp) -> dict:
    """The manifest record for one Experiment (duck-typed: anything with
    the Experiment surface works)."""
    import torch

    dev = torch.device(exp.device)
    channels = (list(exp.bound_obs.channels)
                if exp.bound_obs is not None else [])
    rec = {
        "kind": "manifest",
        "schema": SCHEMA_VERSION,
        "method": exp.method.name,
        "backend": exp.backend,
        "layout": exp.layout,
        "wire": exp.wire,
        "mode": exp.schedule.mode,
        "rounds": int(exp.schedule.rounds),
        "eval_every": int(exp.schedule.eval_every),
        "deadline": exp.deadline,
        "nodes": int(exp.n),
        "num_directed": int(exp._total_directed),
        "seed": int(exp.train.seed),
        "payload_bytes": (float(exp.transport.payload_bytes)
                          if exp.transport is not None else None),
        "channels": channels,
        "env": {
            "python": sys.version.split()[0],
            "torch": torch.__version__,
            "numpy": np.__version__,
            "platform": _platform.platform(),
            "device_type": dev.type,
            "device_count": (torch.cuda.device_count()
                             if dev.type == "cuda" else 1),
        },
    }
    bo = exp.bound_obs
    if (bo is not None and bo.num_directed <= MANIFEST_EDGE_CAP
            and any(c.startswith("edge_") or c == "drift"
                    for c in bo.channels)):
        rec["edges"] = {"src": bo.edge_src.tolist(),
                        "dst": bo.edge_dst.tolist()}
    return validate_record(rec)


def round_record(m) -> dict:
    """One eval round's RoundMetrics -> a validated `round` record."""
    rec = {
        "kind": "round",
        "round": int(m.round),
        "acc_mean": float(m.acc_mean),
        "acc_std": float(m.acc_std),
        "loss_mean": float(m.loss_mean),
        "acc_per_node": np.asarray(m.acc_per_node).tolist(),
    }
    for field in ("bytes_on_wire", "triggered_frac", "live_edge_frac",
                  "sim_time", "arrived_frac"):
        v = getattr(m, field)
        if v is not None:
            rec[field] = float(v)
    if m.detail is not None:
        rec["detail"] = _jsonable(m.detail)
    return validate_record(rec)


class RunLedger:
    """Append-only JSONL writer.  The manifest TRUNCATES the file (one
    ledger = one experiment); every record is validated before it is
    written, so a ledger on disk always re-validates."""

    def __init__(self, path: str):
        self.path = path
        self._started = False

    def write_manifest(self, rec: dict) -> None:
        with open(self.path, "w") as f:
            f.write(json.dumps(validate_record(rec)) + "\n")
        self._started = True

    def write(self, rec: dict) -> None:
        if not self._started:
            raise ValueError("ledger has no manifest yet; RunLedger is "
                             "driven by Experiment — write_manifest first")
        with open(self.path, "a") as f:
            f.write(json.dumps(validate_record(rec)) + "\n")


def read_ledger(path: str):
    """Load a ledger: (manifest, [round records], [summary records]).
    Validates as it reads."""
    manifest, rounds, summaries = None, [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            rec = validate_record(json.loads(line))
            if rec["kind"] == "manifest":
                manifest = rec
            elif rec["kind"] == "round":
                rounds.append(rec)
            else:
                summaries.append(rec)
    if manifest is None:
        raise ValueError(f"{path}: no manifest record")
    return manifest, rounds, summaries


# ------------------------------------------------- the verbose round line

def format_round(method_name: str, m) -> str:
    """The engine's verbose round line, byte for byte the JAX package's
    `Experiment.run(verbose=True)` text."""
    comm = ("" if m.bytes_on_wire is None else
            f"  wire {m.bytes_on_wire / 1e6:.2f} MB"
            f"  trig {m.triggered_frac:.2f}")
    live = ("" if m.live_edge_frac is None else
            f"  live {m.live_edge_frac:.2f}")
    time = ("" if m.sim_time is None else
            f"  t {m.sim_time:.1f}s  arr {m.arrived_frac:.2f}")
    return (f"[{method_name}] round {m.round:4d}  "
            f"acc {m.acc_mean:.4f} ± {m.acc_std:.4f}  "
            f"loss {m.loss_mean:.4f}{comm}{live}{time}")


class _CurrentStdoutHandler(logging.StreamHandler):
    """A StreamHandler that resolves sys.stdout at EMIT time, so pytest's
    capsys (which swaps the stdout object) and user redirections both see
    the verbose lines exactly as `print` did."""

    def __init__(self):
        super().__init__(stream=sys.stdout)

    @property
    def stream(self):
        return sys.stdout

    @stream.setter
    def stream(self, value):  # StreamHandler.__init__ assigns; ignore
        pass


_round_logger: Optional[logging.Logger] = None


def get_round_logger() -> logging.Logger:
    """The ``repro_torch.obs.round`` logger with its stdout handler
    attached once.  It does not propagate (the root logger's formatting
    must not double-print verbose lines); silence it with
    ``logging.getLogger("repro_torch.obs.round").disabled = True`` or swap the
    handler for your own."""
    global _round_logger
    if _round_logger is None:
        logger = logging.getLogger("repro_torch.obs.round")
        logger.setLevel(logging.INFO)
        logger.propagate = False
        if not logger.handlers:
            h = _CurrentStdoutHandler()
            h.setFormatter(logging.Formatter("%(message)s"))
            logger.addHandler(h)
        _round_logger = logger
    return _round_logger


def log_round(method_name: str, m) -> None:
    """Emit one verbose round line through the logging stream."""
    get_round_logger().info(format_round(method_name, m))
