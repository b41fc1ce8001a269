"""whisper-large-v3 [audio, enc-dec] — 32 enc + 32 dec layers, d_model=1280,
20H (MHA), d_ff=5120, vocab=51866; conv frontend STUBBED (precomputed frame
embeddings at seq/2).  [arXiv:2212.04356]"""
from repro_torch.models.lm.config import ArchConfig

CONFIG = ArchConfig(
    arch_id="whisper-large-v3",
    family="encdec",
    citation="arXiv:2212.04356 (Whisper); large-v3 dims",
    n_layers=32,       # decoder layers
    n_enc_layers=32,   # encoder layers
    d_model=1280,
    n_heads=20,
    n_kv_heads=20,
    d_ff=5120,
    vocab=51866,
    norm="layernorm",
    act="gelu",
    rope_theta=1e4,    # RoPE replaces learned abs positions (DESIGN.md §4)
    enc_seq_divisor=2, # conv stride-2 downsampling stand-in
)
