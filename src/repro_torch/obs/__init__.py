"""repro_torch.obs — telemetry channels, the run ledger, and event-clock
trace export.

    from repro_torch.obs import Telemetry, export_trace
    world = World.synthetic(nodes=16, telemetry=Telemetry(
        channels="auto", ledger="run.jsonl"))
    exp = Experiment(world, "decdiff+vt", comm=CommConfig(codec="int8"))
    hist = exp.run(verbose=True)
    hist[-1].detail["consensus"]             # per-node ‖w_i − w̄‖
    export_trace(exp, "trace.json")          # open in Perfetto

Opt-in and free of side effects when off: the channel accumulators ride
the round's state on the device (read back with the round's other
accounting, never drawing from a generator), and `telemetry=None` is
bitwise a run without this package, as is every parameter, byte count and
clock value with every channel on (tests/test_torch_obs.py).
"""
from repro_torch.obs.channels import (  # noqa: F401
    CHANNELS,
    BoundTelemetry,
    ChannelSpec,
    Telemetry,
    available_channels,
    channels_for,
)
from repro_torch.obs.ledger import (  # noqa: F401
    MANIFEST_EDGE_CAP,
    SCHEMA,
    SCHEMA_VERSION,
    RunLedger,
    format_round,
    get_round_logger,
    log_round,
    read_ledger,
    round_record,
    run_manifest,
    validate_ledger,
    validate_record,
)
from repro_torch.obs.trace import build_trace, export_trace  # noqa: F401
