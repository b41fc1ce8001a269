"""qwen1.5-0.5b [dense] — 24L d_model=1024 16H (kv=16, MHA) d_ff=2816
vocab=151936; QKV bias.  [hf:Qwen/Qwen1.5-0.5B]"""
from repro_torch.models.lm.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="qwen1.5-0.5b",
    family="dense",
    citation="hf:Qwen/Qwen1.5-0.5B",
    n_layers=24,
    d_model=1024,
    n_heads=16,
    n_kv_heads=16,
    d_ff=2816,
    vocab=151936,
    qk_norm=False,
    qkv_bias=True,
    rope_theta=1e6,
    norm="rmsnorm",
    act="silu",
    tie_embeddings=True,
)
