"""repro_torch.comm — the gossip transport between training and aggregation.

  codecs    — payload compression (fp32 / bf16 / int8 with error feedback
              and stochastic rounding / top-k with optional momentum), each
              with exact bytes_on_wire;
  trigger   — event-triggered transmission: send only when the model has
              drifted past a threshold since the last payload, per node or
              per edge (drift-rate-adaptive per-edge thresholds);
  transport — CommConfig + GossipTransport (per-node state, either
              layout) + EdgeGossipTransport (per-edge `[N, max_deg, ...]`
              state, dense layout) + SparseEdgeGossipTransport (per-edge
              `[E, ...]` state over the sparse CSR edge list).

Receivers always decode before aggregating, so DecDiff's Eq. 5-6 act on
reconstructed models; only the bytes on the wire change.  Every exchange
is written against a `PodContext` (a row slice and an all-gather over the
pod backend's mesh; `DENSE_CTX` holds all N rows).
"""
from repro_torch.comm.codecs import (  # noqa: F401
    CODECS,
    BF16Codec,
    Codec,
    FP32Codec,
    Int8Codec,
    TopKCodec,
    make_codec,
    payload_nbytes,
)
from repro_torch.comm.transport import (  # noqa: F401
    DENSE_CTX,
    WIRES,
    CommConfig,
    CommState,
    EdgeCommState,
    EdgeGossipTransport,
    GossipTransport,
    PodContext,
    SparseEdgeCommState,
    SparseEdgeGossipTransport,
    codec_roundtrip_stacked,
)
from repro_torch.comm.trigger import (  # noqa: F401
    adaptive_threshold_update,
    drift_gate,
    edge_delivery,
    edge_drift_gate,
)
