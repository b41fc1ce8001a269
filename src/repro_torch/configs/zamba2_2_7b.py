"""zamba2-2.7b [hybrid] — 54 Mamba2 layers d_model=2560 + ONE shared
attention block (32H MHA kv=32, d_ff=10240) invoked every 9 layers;
ssm_state=64.  Per-invocation LoRA deltas omitted (DESIGN.md §4).
[arXiv:2411.15242]"""
from repro_torch.models.lm.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="zamba2-2.7b",
    family="hybrid",
    citation="arXiv:2411.15242 (Zamba2)",
    n_layers=54,
    d_model=2560,
    n_heads=32,
    n_kv_heads=32,
    d_ff=10240,
    vocab=32000,
    ssm_state=64,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    ssm_groups=1,
    shared_attn_every=9,
    rope_theta=1e4,
    norm="rmsnorm",
    act="silu",
)
