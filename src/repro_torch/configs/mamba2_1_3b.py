"""mamba2-1.3b [ssm] — SSD (state-space duality), attention-free.

48L d_model=2048 vocab=50280 ssm_state=128
[arXiv:2405.21060; unverified]

d_inner = expand * d_model = 4096, head_dim = 64 -> 64 SSD heads, conv width 4,
chunk size 256 for the chunked SSD scan.
"""

from repro_torch.configs.base import ModelConfig, SSMConfig

CONFIG = ModelConfig(
    name="mamba2-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=1,                # unused by SSD blocks
    num_kv_heads=1,
    d_ff=0,                     # attention-free, no separate MLP block
    vocab_size=50_280,
    tie_embeddings=True,
    ssm=SSMConfig(
        d_state=128,
        d_conv=4,
        expand=2,
        head_dim=64,
        chunk_size=256,
    ),
    source="arXiv:2405.21060; unverified",
)
