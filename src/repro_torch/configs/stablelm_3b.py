"""stablelm-3b [dense] — MHA, partial rotary embeddings.

32L d_model=2560 32H (GQA kv=32) d_ff=6912 vocab=50304
[hf:stabilityai/stablelm-2-1_6b; unverified]
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="stablelm-3b",
    family="dense",
    num_layers=32,
    d_model=2560,
    num_heads=32,
    num_kv_heads=32,
    head_dim=80,
    d_ff=6912,
    vocab_size=50_304,
    mlp_kind="silu_glu",
    norm_kind="layernorm",
    rope_pct=0.25,              # stablelm-family partial rotary
    rope_theta=10_000.0,
    source="hf:stabilityai/stablelm-2-1_6b; unverified",
)
