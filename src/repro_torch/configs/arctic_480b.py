"""arctic-480b [moe] — 35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000;
MoE 128 experts top-2 IN PARALLEL with a dense residual MLP per layer
(dense-MoE hybrid).  [hf:Snowflake/snowflake-arctic-base]"""
from repro_torch.models.lm.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="arctic-480b",
    family="moe",
    citation="hf:Snowflake/snowflake-arctic-base",
    n_layers=35,
    d_model=7168,
    n_heads=56,
    n_kv_heads=8,
    head_dim=128,
    d_ff=4864,
    vocab=32000,
    n_experts=128,
    top_k=2,
    dense_residual=True,
    rope_theta=1e6,
    norm="rmsnorm",
    act="silu",
)
