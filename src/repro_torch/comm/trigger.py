"""Event-triggered transmission policy, as in the JAX package's
`repro.comm.trigger`.

A node transmits only when its model has drifted since the last payload it
put on the wire.  Two granularities:

  per-NODE (`drift_gate`): one reference per sender,

      send_i = 1{ ||w_i - w_i^last_sent||_2 >= threshold },

  per-EDGE (`edge_drift_gate`): one reference per directed link (i -> j),
  laid out `[N, max_deg]` in the padded-neighbour geometry,

      send_ij = 1{ ||w_i - w_ij^last_sent||_2 >= threshold_ij }.

threshold = 0 degenerates to always-send.  Per-edge thresholds can be
*adaptive* (`adaptive_threshold_update`): a Robbins-Monro quantile tracker
per edge whose step is scaled by the edge's drift EMA, so each link's
long-run triggered fraction converges to `target`.  Exogenous link failures
compose multiplicatively on top (`edge_delivery`).

Every drift is one row of `ops.drift_norms`, a per-row reduction whose
sum over a row does not depend on how many rows the call holds (on the
card, Eq. 5's sum-of-squares kernel): a pod backend's block of R nodes
gets the norms of the full node axis, and the dense and sparse per-edge
layouts, which hold the same edges in rows of another shape, agree.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import ops

# Floor for the EMA-scaled adaptation step: keeps the controller live when an
# edge's drift collapses to ~0 (converged model) without letting the
# threshold run away in units the drift can never reach again.
EMA_FLOOR = 1e-8


def drift_gate(w: torch.Tensor, last_sent: torch.Tensor, threshold: float):
    """w, last_sent [N, D] flat models; threshold in global-L2 units (0 =
    always send) -> (gate [N] {0.,1.} float32, drift [N] float32)."""
    drift = ops.drift_norms(w.to(torch.float32).contiguous(),
                            last_sent.to(torch.float32).contiguous())
    thr = torch.tensor(threshold, dtype=torch.float32, device=w.device)
    return (drift >= thr).to(torch.float32), drift


def edge_drift_gate(w: torch.Tensor, last_sent: torch.Tensor, threshold,
                    valid: torch.Tensor):
    """w [N, D]; last_sent [N, E, D] per-edge references; threshold [N, E]
    (or a scalar); valid [N, E] {0,1} (padding never fires) ->
    (gate [N, E] {0.,1.} float32, drift [N, E] float32)."""
    ref = last_sent.to(torch.float32)
    d = ref.shape[-1]
    x = w.to(torch.float32)[:, None, :].expand(ref.shape)
    drift = ops.drift_norms(x.reshape(-1, d).contiguous(),
                            ref.reshape(-1, d).contiguous()
                            ).reshape(ref.shape[:-1])
    gate = (drift >= threshold).to(torch.float32) * valid
    return gate, drift


def adaptive_threshold_update(threshold, drift_ema, drift, gate, valid, *,
                              target: float, ema_beta: float, rate: float):
    """One step of the per-edge drift-rate controller:

        ema' = beta·ema + (1-beta)·drift   (seeded with drift while ema = 0)
        thr' = max(0, thr + rate · max(ema', floor) · (gate - target))

    on valid edges; padding slots stay frozen.  All arguments [N, E].
    Returns (new_threshold, new_drift_ema)."""
    new_ema = torch.where(drift_ema > 0,
                          ema_beta * drift_ema + (1.0 - ema_beta) * drift,
                          drift)
    step = rate * torch.clamp(new_ema, min=EMA_FLOOR) * (gate - target)
    new_thr = torch.clamp(threshold + step, min=0.0)
    keep = valid > 0
    return (torch.where(keep, new_thr, threshold),
            torch.where(keep, new_ema, drift_ema))


def edge_delivery(gate: torch.Tensor, link_mask: torch.Tensor,
                  nbr_idx: torch.Tensor) -> torch.Tensor:
    """gate [N] sender gates, link_mask [N, E] receiver-layout link mask
    (validity included), nbr_idx [N, E] -> [N, E] delivery mask: slot e of
    node i delivers iff neighbour nbr_idx[i, e] transmitted and the link
    stayed up."""
    return link_mask * gate[nbr_idx]
