"""deepseek-moe-16b [moe] — fine-grained MoE, 2 shared + 64 routed top-6.

28L d_model=2048 16H (MHA) d_ff=1408(expert) vocab=102400
[arXiv:2401.06066; hf]

First layer uses a dense FFN (d_ff=10944).
"""

from repro_torch.configs.base import ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-moe-16b",
    family="moe",
    num_layers=28,
    d_model=2048,
    num_heads=16,
    num_kv_heads=16,
    head_dim=128,
    d_ff=1408,
    vocab_size=102_400,
    mlp_kind="silu_glu",
    rope_theta=10_000.0,
    moe=MoEConfig(
        num_experts=64,
        num_shared_experts=2,
        top_k=6,
        d_ff=1408,
        n_dense_layers=1,
        dense_d_ff=10944,
    ),
    source="arXiv:2401.06066; hf",
)
