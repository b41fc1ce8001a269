"""mamba2-2.7b [ssm] — 64L d_model=2560, attention-free, SSD (state-space
duality), ssm_state=128, d_inner=5120, head_dim=64 (80 heads), conv4.
vocab=50280.  [arXiv:2405.21060]"""
from repro_torch.models.lm.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="mamba2-2.7b",
    family="ssm",
    citation="arXiv:2405.21060 (Mamba2 / SSD)",
    n_layers=64,
    d_model=2560,
    n_heads=0,  # attention-free
    n_kv_heads=0,
    head_dim=1,
    d_ff=0,
    vocab=50280,
    ssm_state=128,
    ssm_head_dim=64,
    ssm_expand=2,
    ssm_conv=4,
    ssm_chunk=256,
    ssm_groups=1,
    norm="rmsnorm",
    act="silu",
)
