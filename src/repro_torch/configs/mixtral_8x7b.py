"""mixtral-8x7b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=32000; 8 experts top-2, sliding-window attention (4096).
[arXiv:2401.04088]"""
from repro_torch.models.lm.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="mixtral-8x7b",
    family="moe",
    citation="arXiv:2401.04088 (Mixtral of Experts)",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    n_experts=8,
    top_k=2,
    sliding_window=4096,
    rope_theta=1e6,
    norm="rmsnorm",
    act="silu",
)
