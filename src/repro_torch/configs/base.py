"""Config dataclasses shared by every architecture.

Design notes
------------
* ``ModelConfig`` is a frozen dataclass covering every model family in the
  assigned pool (dense/GQA, MLA+MoE, SSM, RG-LRU hybrid, enc-dec, VLM).
  Family-specific fields default to "off" so each arch file only states what
  it uses.
* ``ShapeConfig`` is one of the four assigned input shapes.  ``kind`` selects
  which step function the dry-run lowers (train_step vs serve prefill/decode).
* ``reduced()`` produces the smoke-test variant of a config: same family
  features (MoE routing, MLA projections, SSD scan, hybrid pattern, ...) at
  toy width so a single CPU device can run a real forward/backward step.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass(frozen=True)
class MoEConfig:
    """Mixture-of-experts settings (DeepSeek-style fine-grained MoE)."""

    num_experts: int = 0            # routed experts
    num_shared_experts: int = 0     # always-on experts
    top_k: int = 0
    d_ff: int = 0                   # per-expert hidden dim
    n_dense_layers: int = 0         # leading layers that use a dense FFN
    dense_d_ff: int = 0             # hidden dim of those dense layers
    capacity_factor: float = 1.25   # capacity-based dispatch (GShard-style)
    router_aux_weight: float = 0.001

    @property
    def enabled(self) -> bool:
        return self.num_experts > 0


@dataclass(frozen=True)
class MLAConfig:
    """Multi-head latent attention (DeepSeek-V2/V3)."""

    q_lora_rank: int = 0
    kv_lora_rank: int = 0
    qk_nope_head_dim: int = 0
    qk_rope_head_dim: int = 0
    v_head_dim: int = 0

    @property
    def enabled(self) -> bool:
        return self.kv_lora_rank > 0


@dataclass(frozen=True)
class SSMConfig:
    """Mamba2 / SSD settings."""

    d_state: int = 0
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64
    chunk_size: int = 256

    @property
    def enabled(self) -> bool:
        return self.d_state > 0


@dataclass(frozen=True)
class RecurrentConfig:
    """RG-LRU (RecurrentGemma/Griffin) settings."""

    lru_width: int = 0
    conv_width: int = 4
    # block pattern, cycled over layers: "r" = recurrent block, "a" = attention
    block_pattern: Tuple[str, ...] = ()

    @property
    def enabled(self) -> bool:
        return self.lru_width > 0


@dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                     # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0               # 0 -> d_model // num_heads

    # ---- attention features -------------------------------------------------
    qk_norm: bool = False           # qwen3-style per-head RMSNorm on q/k
    rope_theta: float = 10000.0
    rope_pct: float = 1.0           # stablelm uses partial rotary (25%)
    sliding_window: int = 0         # 0 -> full attention
    attn_logit_softcap: float = 0.0

    # ---- MLP ----------------------------------------------------------------
    mlp_kind: str = "silu_glu"      # silu_glu | geglu | gelu
    norm_kind: str = "rmsnorm"      # rmsnorm | layernorm
    tie_embeddings: bool = False

    # ---- family sub-configs ---------------------------------------------------
    moe: MoEConfig = field(default_factory=MoEConfig)
    mla: MLAConfig = field(default_factory=MLAConfig)
    ssm: SSMConfig = field(default_factory=SSMConfig)
    rec: RecurrentConfig = field(default_factory=RecurrentConfig)

    # ---- enc-dec ----------------------------------------------------------------
    encoder_layers: int = 0         # >0 -> encoder-decoder; num_layers = decoder
    # ratio of target length to source length for enc-dec training shapes
    tgt_ratio: float = 0.25

    # ---- VLM ---------------------------------------------------------------------
    num_image_tokens: int = 0       # >0 -> precomputed patch embeddings spliced

    # ---- numerics -----------------------------------------------------------------
    dtype: str = "bfloat16"         # activations/params compute dtype

    # ---- runtime/layout choices (overridden per run, not per arch) -----------
    moe_dispatch: str = "local"     # local | a2a (2D expert parallelism)

    # ---- provenance -----------------------------------------------------------
    source: str = ""                # citation tag from the assignment table

    # ------------------------------------------------------------------------
    @property
    def head_dim_(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def attention_free(self) -> bool:
        return self.family == "ssm"

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch serve a 500k-token context?"""
        return self.family in ("ssm", "hybrid")

    def param_count(self) -> int:
        """Parameter count, from the parameter shapes on the meta device."""
        from repro_torch.models.model_zoo import analytic_param_count

        return analytic_param_count(self)

    def active_param_count(self) -> int:
        """Parameters a token runs through (an MoE layer's top-k routed
        experts, not all of them)."""
        from repro_torch.models.model_zoo import analytic_param_count

        return analytic_param_count(self, active_only=True)


@dataclass(frozen=True)
class ShapeConfig:
    name: str
    kind: str                       # train | prefill | decode
    seq_len: int
    global_batch: int

    @property
    def tokens(self) -> int:
        """Tokens processed per step (decode: one new token per sequence)."""
        if self.kind == "decode":
            return self.global_batch
        return self.seq_len * self.global_batch


# The four assigned input shapes (identical for all 10 LM-family archs).
SHAPES: dict[str, ShapeConfig] = {
    "train_4k": ShapeConfig("train_4k", "train", 4_096, 256),
    "prefill_32k": ShapeConfig("prefill_32k", "prefill", 32_768, 32),
    "decode_32k": ShapeConfig("decode_32k", "decode", 32_768, 128),
    "long_500k": ShapeConfig("long_500k", "decode", 524_288, 1),
}


def applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """Whether an (arch, shape) cell runs, per the assignment rules."""
    if shape.name == "long_500k" and not cfg.sub_quadratic:
        return False, "long_500k needs sub-quadratic attention; %s is full-attention" % cfg.family
    return True, ""


def reduced(cfg: ModelConfig) -> ModelConfig:
    """Smoke-test variant: same family features, toy width."""
    ch: dict = dict(
        name=cfg.name + "-smoke",
        num_layers=min(cfg.num_layers, 4),
        d_model=64,
        num_heads=4,
        num_kv_heads=min(cfg.num_kv_heads, 4) if cfg.num_kv_heads > 1 else 1,
        head_dim=16,
        d_ff=128,
        vocab_size=512,
        sliding_window=min(cfg.sliding_window, 16) if cfg.sliding_window else 0,
    )
    if cfg.moe.enabled:
        ch["moe"] = dataclasses.replace(
            cfg.moe,
            num_experts=8,
            num_shared_experts=min(cfg.moe.num_shared_experts, 2),
            top_k=2,
            d_ff=32,
            n_dense_layers=min(cfg.moe.n_dense_layers, 1),
            dense_d_ff=128,
        )
    if cfg.mla.enabled:
        ch["mla"] = MLAConfig(
            q_lora_rank=32, kv_lora_rank=32,
            qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
        )
    if cfg.ssm.enabled:
        ch["ssm"] = dataclasses.replace(
            cfg.ssm, d_state=16, head_dim=16, chunk_size=32)
    if cfg.rec.enabled:
        ch["rec"] = dataclasses.replace(cfg.rec, lru_width=64, conv_width=4)
        ch["num_layers"] = max(len(cfg.rec.block_pattern), 3)
    if cfg.encoder_layers:
        ch["encoder_layers"] = 2
    if cfg.num_image_tokens:
        ch["num_image_tokens"] = 8
    return dataclasses.replace(cfg, **ch)
