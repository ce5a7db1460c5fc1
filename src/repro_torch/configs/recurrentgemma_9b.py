"""recurrentgemma-9b [hybrid] — RG-LRU + local attention, 2 recurrent : 1 attn.

38L d_model=4096 16H (GQA kv=1) d_ff=12288 vocab=256000
[arXiv:2402.19427; unverified]
"""

from repro_torch.configs.base import ModelConfig, RecurrentConfig

CONFIG = ModelConfig(
    name="recurrentgemma-9b",
    family="hybrid",
    num_layers=38,
    d_model=4096,
    num_heads=16,
    num_kv_heads=1,
    head_dim=256,
    d_ff=12288,
    vocab_size=256_000,
    sliding_window=2048,        # local attention window for the "a" blocks
    mlp_kind="geglu",
    rope_theta=10_000.0,
    tie_embeddings=True,
    rec=RecurrentConfig(
        lru_width=4096,
        conv_width=4,
        block_pattern=("r", "r", "a"),
    ),
    source="arXiv:2402.19427; unverified",
)
