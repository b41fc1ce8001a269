"""qwen3-32b [dense] — 64L d_model=5120 64H (GQA kv=8) d_ff=25600
vocab=151936; qk_norm, GQA, head_dim=128.  [hf:Qwen/Qwen3-8B family card]"""
from repro_torch.models.lm.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen3-32b",
    family="dense",
    citation="hf:Qwen/Qwen3-8B (qwen3 family; 32B variant dims)",
    n_layers=64,
    d_model=5120,
    n_heads=64,
    n_kv_heads=8,
    head_dim=128,
    d_ff=25600,
    vocab=151936,
    qk_norm=True,
    qkv_bias=False,
    rope_theta=1e6,
    norm="rmsnorm",
    act="silu",
)
