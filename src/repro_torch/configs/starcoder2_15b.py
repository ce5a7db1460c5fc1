"""starcoder2-15b [dense] — GQA, RoPE, non-gated GELU MLP, LayerNorm.

40L d_model=6144 48H (GQA kv=4) d_ff=24576 vocab=49152
[arXiv:2402.19173; hf]

Note: the released model uses a 4k sliding window; the assignment classifies it
as a full-attention dense arch, so we model full attention (long_500k skipped
either way — see DESIGN.md §4).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="starcoder2-15b",
    family="dense",
    num_layers=40,
    d_model=6144,
    num_heads=48,
    num_kv_heads=4,
    head_dim=128,
    d_ff=24576,
    vocab_size=49_152,
    mlp_kind="gelu",
    norm_kind="layernorm",
    rope_theta=100_000.0,
    source="arXiv:2402.19173; hf",
)
