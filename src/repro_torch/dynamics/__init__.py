"""repro_torch.dynamics — time-varying topologies.

    from repro_torch.dynamics import EdgeDropout
    world = World.synthetic(nodes=16, topology="barabasi_albert", m=2,
                            dynamics=EdgeDropout(p=0.2))
    Experiment(world, "decdiff+vt").run()

A :class:`GraphProcess` turns the world's static topology into a per-round
sequence of edge masks: i.i.d. edge dropout, Gilbert–Elliott bursty links,
node churn (with per-edge comm-state reset on rejoin), periodic rewiring,
scripted mask-table replay and drift-adaptive energy churn (observing the
`repro_torch.timing` event clock's realized compute cost).  Each round is
one draw from the experiment's generator (random processes only) and one
pure state transition on the device.
"""
from repro_torch.dynamics.processes import (  # noqa: F401
    PROCESSES,
    BoundProcess,
    EdgeDropout,
    EnergyChurn,
    GilbertElliott,
    GraphEvent,
    GraphProcess,
    NodeChurn,
    PeriodicRewiring,
    ScriptedGraph,
    StaticGraph,
    make_process,
)
