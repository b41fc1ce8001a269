"""Architecture configuration for the assigned large models.

One dataclass covers all six families (dense / moe / ssm / hybrid / encdec /
vlm); family-specific fields are simply unused elsewhere.  The exact per-arch
values live in :mod:`repro_torch.configs` (one file per architecture, citing
its source model card / paper).  A copy of the JAX package's
`repro.models.lm.config`: every field and default is the same, dtypes stay
names, and `torch_dtype` maps a name to its `torch.dtype`.
`repro_torch.models.lm.build_lm` builds a model of every family.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
           "float16": torch.float16}


def torch_dtype(name: str) -> torch.dtype:
    """The `torch.dtype` of a dtype name used in the configs."""
    if name not in _DTYPES:
        raise ValueError(f"unknown dtype name {name!r}; known: "
                         f"{sorted(_DTYPES)}")
    return _DTYPES[name]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    arch_id: str
    family: str  # dense | moe | ssm | hybrid | encdec | vlm
    citation: str = ""

    # transformer trunk
    n_layers: int = 2
    d_model: int = 256
    n_heads: int = 4
    n_kv_heads: Optional[int] = None  # None -> MHA (= n_heads)
    head_dim: Optional[int] = None  # None -> d_model // n_heads
    d_ff: int = 1024
    vocab: int = 1024
    qk_norm: bool = False  # qwen3-style per-head RMSNorm on q and k
    qkv_bias: bool = False  # qwen1.5/2.5-style bias on qkv projections
    rope_theta: float = 1e6
    norm: str = "rmsnorm"  # rmsnorm | layernorm
    act: str = "silu"  # silu (GLU) | gelu (plain MLP)
    tie_embeddings: bool = False
    sliding_window: Optional[int] = None  # SWA window (mixtral: 4096)

    # attention execution strategy
    attn_chunk_q: int = 512  # flash-style chunking for long sequences
    attn_chunk_kv: int = 1024
    full_attn_max_seq: int = 4096  # use plain attention at/below this length

    # MoE
    n_experts: int = 0
    top_k: int = 2
    dense_residual: bool = False  # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01  # load-balance loss weight

    # SSM (mamba2 / SSD)
    ssm_state: int = 0  # N
    ssm_head_dim: int = 64  # P
    ssm_expand: int = 2
    ssm_conv: int = 4
    ssm_chunk: int = 256
    ssm_groups: int = 1

    # hybrid (zamba2)
    shared_attn_every: int = 0  # 0 = no shared block

    # encdec (whisper)
    n_enc_layers: int = 0
    enc_seq_divisor: int = 2  # stub conv frontend downsampling factor

    # vlm (llava)
    img_tokens: int = 0  # anyres: base 576 + tiles

    # dtypes
    param_dtype: str = "bfloat16"
    activation_dtype: str = "bfloat16"
    remat: bool = True
    # The JAX package's dry-run calibration unrolls its layer scan with
    # this; the port's layer loop is a Python loop and reads it nowhere.
    scan_unroll: bool = False

    # ---- §Perf levers (default off = paper-faithful baseline) ----
    # ZeRO-3 use-site weight gather: constrain per-layer weight slices to
    # model-axis-only sharding so GSPMD all-gathers weights over data rather
    # than psum-ing activations (EXPERIMENTS.md §Perf iteration 1).
    zero3_gather: bool = False
    # Residual-stream/scan-carry sharding: "batch" (baseline) or "batch_seq"
    # (seq dim sharded over model between layers — memory-capacity lever).
    residual_shard: str = "batch"
    # Cast softmax probabilities to bf16 before the attention combine
    # (halves the largest prefill/train buffer's traffic).
    attn_probs_bf16: bool = False
    # MoE dispatch strategy: "global" capacity pool (baseline) or
    # "batch_local" (per-row dispatch; expert buffers stay batch-sharded —
    # kills the global-buffer all-reduce, see §Perf).
    moe_dispatch: str = "global"
    # Expert parallelism: shard the expert dim of expert weights (and the
    # dispatch buffers) over the model axis when E % axis == 0.  The dispatch
    # becomes an all-to-all of activations instead of gathering the (huge)
    # expert weights — the right trade for many-expert models (arctic).
    expert_parallel: bool = False

    # serving
    decode_window: Optional[int] = None  # ring-buffer cache size for long ctx

    def __post_init__(self):
        if self.n_kv_heads is None:
            object.__setattr__(self, "n_kv_heads", self.n_heads)
        if self.head_dim is None and self.n_heads:
            object.__setattr__(self, "head_dim", self.d_model // self.n_heads)

    # ---------------- derived ----------------
    @property
    def pdtype(self) -> torch.dtype:
        return torch_dtype(self.param_dtype)

    @property
    def adtype(self) -> torch.dtype:
        return torch_dtype(self.activation_dtype)

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.head_dim

    @property
    def kv_dim(self) -> int:
        return self.n_kv_heads * self.head_dim

    @property
    def ssm_inner(self) -> int:
        return self.d_model * self.ssm_expand

    @property
    def ssm_heads(self) -> int:
        return self.ssm_inner // self.ssm_head_dim

    def reduced(self, **overrides) -> "ArchConfig":
        """Smoke-test variant of the same family: tiny but structurally
        identical (2 layers, d_model <= 512, <= 4 experts)."""
        small = dict(
            n_layers=2,
            d_model=min(self.d_model, 256),
            n_heads=min(self.n_heads, 4),
            n_kv_heads=min(self.n_kv_heads or self.n_heads, 2),
            head_dim=64,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab=min(self.vocab, 512),
            n_experts=min(self.n_experts, 4) if self.n_experts else 0,
            n_enc_layers=2 if self.n_enc_layers else 0,
            ssm_state=min(self.ssm_state, 32) if self.ssm_state else 0,
            ssm_head_dim=32 if self.ssm_state else self.ssm_head_dim,
            ssm_chunk=32 if self.ssm_state else self.ssm_chunk,
            shared_attn_every=2 if self.shared_attn_every else 0,
            img_tokens=min(self.img_tokens, 16) if self.img_tokens else 0,
            sliding_window=min(self.sliding_window, 64) if self.sliding_window else None,
            full_attn_max_seq=64,
            attn_chunk_q=16,
            attn_chunk_kv=32,
            param_dtype="float32",
            activation_dtype="float32",
            remat=False,
        )
        small.update(overrides)
        return dataclasses.replace(self, **small)

    def param_count(self) -> int:
        """Analytic parameter count (used for roofline MODEL_FLOPS=6ND)."""
        d, f, v = self.d_model, self.d_ff, self.vocab
        attn = d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
        if self.qkv_bias:
            attn += self.q_dim + 2 * self.kv_dim
        glu = 3 if self.act == "silu" else 2
        mlp = glu * d * f
        norms = 2 * d
        emb = v * d * (1 if self.tie_embeddings else 2)
        if self.family in ("dense", "vlm"):
            return self.n_layers * (attn + mlp + norms) + emb + d
        if self.family == "moe":
            moe = self.n_experts * glu * d * f + d * self.n_experts
            dense_res = glu * d * f if self.dense_residual else 0
            return self.n_layers * (attn + moe + dense_res + norms) + emb + d
        if self.family == "ssm":
            di, n, h = self.ssm_inner, self.ssm_state, self.ssm_heads
            g = self.ssm_groups
            in_proj = d * (2 * di + 2 * g * n + h)
            out_proj = di * d
            conv = self.ssm_conv * (di + 2 * g * n)
            per = in_proj + out_proj + conv + 2 * h + di + d
            return self.n_layers * per + emb + d
        if self.family == "hybrid":
            ssm_cfg = dataclasses.replace(self, family="ssm")
            base = ssm_cfg.param_count() - emb - d
            shared = attn + mlp + norms
            return base + shared + emb + d
        if self.family == "encdec":
            enc = self.n_enc_layers * (attn + mlp + norms)
            dec = self.n_layers * (2 * attn + mlp + 3 * d)
            return enc + dec + emb + d
        raise ValueError(self.family)

    def active_param_count(self) -> int:
        """Active parameters per token (MoE: only top_k experts count)."""
        if self.family != "moe":
            return self.param_count()
        d, f = self.d_model, self.d_ff
        glu = 3 if self.act == "silu" else 2
        inactive = self.n_layers * (self.n_experts - self.top_k) * glu * d * f
        return self.param_count() - inactive
