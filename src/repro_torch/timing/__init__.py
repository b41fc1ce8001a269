"""repro_torch.timing — the event clock: time-to-accuracy, not rounds.

    from repro_torch.timing import Timing, LognormalStep, LognormalLink
    world = World.synthetic(nodes=16, topology="barabasi_albert", m=2,
                            timing=Timing(node=LognormalStep(sigma=0.5),
                                          link=LognormalLink()))
    Experiment(world, "decdiff+vt", comm=...,
               schedule=Schedule(rounds=100, deadline=6.0)).run()

A :class:`Timing` prices every round in simulated seconds: per-node step
times and per-edge latency + bandwidth, each payload costing its codec's
exact bytes on the wire.  ``Schedule(deadline=d)`` makes each round a
deadline tick: a payload is delivered iff ``send_time + latency +
bytes / bandwidth <= d``, late arrivals fall into the stale / drop silence
paths, and stragglers train fewer local steps.  With ``deadline=None`` the
schedule stays synchronous (every round waits for the slowest node and
link) and the clock reports the makespan.
"""
from repro_torch.timing.models import (  # noqa: F401
    LINK_MODELS,
    NODE_MODELS,
    PAST_END,
    BoundTiming,
    ConstantLink,
    ConstantStep,
    LinkTimeModel,
    LognormalLink,
    LognormalStep,
    NodeTimeModel,
    StragglerStep,
    TableLink,
    Timing,
    TimingState,
    TraceStep,
    make_link_model,
    make_node_model,
    past_end_index,
)
