"""qwen2.5-14b [dense] — 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064; GQA + QKV bias.  [hf:Qwen/Qwen2.5-0.5B family card; 14B dims]"""
from repro_torch.models.lm.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen2.5-14b",
    family="dense",
    citation="hf:Qwen/Qwen2.5-0.5B (qwen2.5 family; 14B variant dims)",
    n_layers=48,
    d_model=5120,
    n_heads=40,
    n_kv_heads=8,
    d_ff=13824,
    vocab=152064,
    qk_norm=False,
    qkv_bias=True,
    rope_theta=1e6,
    norm="rmsnorm",
    act="silu",
)
