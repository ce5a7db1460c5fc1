"""llava-next-mistral-7b [vlm] — Mistral-7B backbone, anyres patch embeddings.

32L d_model=4096 32H (GQA kv=8) d_ff=14336 vocab=32000
[hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified]

The modality frontend (CLIP ViT + anyres tiling + projector) is a STUB per the
assignment: precomputed patch embeddings ``img_emb`` of shape
(batch, num_image_tokens, d_model) (``make_batch``'s vlm batch) are spliced
in front of the text tokens.
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="llava-next-mistral-7b",
    family="vlm",
    num_layers=32,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    head_dim=128,
    d_ff=14336,
    vocab_size=32_000,
    mlp_kind="silu_glu",
    rope_theta=1_000_000.0,
    num_image_tokens=2880,      # anyres: 5 tiles x 576 patches
    source="hf:llava-hf/llava-v1.6-mistral-7b-hf; unverified",
)
