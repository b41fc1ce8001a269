"""The transport-capable methods under the bf16 and top-k transports
against the reference, on the CPU: the cases of
tests/test_torch_roster.py (the world, the helpers, the tolerances and
their reasons) for bf16 per edge at threshold 0.3 and top-k 5% per edge
with momentum 0.5.  Bytes on the wire, the triggered fraction and
accuracies exactly equal; params within 1e-4 plus one grain of the codec
(bf16: the largest |param| · 2^-7; top-k: the largest |param|).
"""
import pytest

pytest.importorskip("torch")
pytest.importorskip("jax")

from test_torch_roster import (  # noqa: E402,F401  (fixtures too)
    TRANSPORT_METHODS, _check, jworld, tworld)

CODECS = {
    "bf16-edge-thr": dict(codec="bf16", per_edge=True,
                          trigger_threshold=0.3),
    "topk-edge-momentum": dict(codec="topk", topk_ratio=0.05,
                               topk_momentum=0.5, per_edge=True),
}


@pytest.mark.parametrize("case", sorted(CODECS))
@pytest.mark.parametrize("method", TRANSPORT_METHODS)
def test_method_matches_jax_with_transport(jworld, tworld, method, case):
    _check(jworld, tworld, method, CODECS[case], 1e-4)
