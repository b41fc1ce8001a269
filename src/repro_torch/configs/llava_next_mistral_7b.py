"""llava-next-mistral-7b [vlm] — mistral-7B text trunk: 32L d_model=4096 32H
(GQA kv=8) d_ff=14336 vocab=32000; vision tower + projector STUBBED, anyres
tiling = 576 base + 4x576 tile patch embeddings (2880 image tokens).
[hf:llava-hf/llava-v1.6-mistral-7b-hf]"""
from repro_torch.models.lm.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="llava-next-mistral-7b",
    family="vlm",
    citation="hf:llava-hf/llava-v1.6-mistral-7b-hf",
    n_layers=32,
    d_model=4096,
    n_heads=32,
    n_kv_heads=8,
    d_ff=14336,
    vocab=32000,
    img_tokens=2880,  # anyres: 576 + 4*576
    rope_theta=1e6,
    norm="rmsnorm",
    act="silu",
)
