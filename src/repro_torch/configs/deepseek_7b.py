"""deepseek-7b [dense] — 30L d_model=4096 32H (kv=32, MHA) d_ff=11008
vocab=102400; llama architecture.  [arXiv:2401.02954]"""
from repro_torch.models.lm.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="deepseek-7b",
    family="dense",
    citation="arXiv:2401.02954 (DeepSeek LLM)",
    n_layers=30,
    d_model=4096,
    n_heads=32,
    n_kv_heads=32,
    d_ff=11008,
    vocab=102400,
    rope_theta=1e4,
    norm="rmsnorm",
    act="silu",
)
