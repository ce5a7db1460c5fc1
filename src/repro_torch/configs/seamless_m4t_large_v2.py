"""seamless-m4t-large-v2 [audio] — encoder-decoder transformer backbone.

24L d_model=1024 16H (MHA) d_ff=8192 vocab=256206
[arXiv:2308.11596; unverified]

We model the text-to-text backbone: a 24-layer encoder + 24-layer decoder with
cross-attention.  The speech frontend (w2v-BERT conformer) is a STUB per the
assignment: the encoder consumes precomputed frame embeddings ``src_emb``
(batch, src_len, d_model) directly (``make_batch``'s encdec batch).
"""

from repro_torch.configs.base import ModelConfig

CONFIG = ModelConfig(
    name="seamless-m4t-large-v2",
    family="encdec",
    num_layers=24,              # decoder layers
    encoder_layers=24,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,
    head_dim=64,
    d_ff=8192,
    vocab_size=256_206,
    mlp_kind="gelu",
    norm_kind="layernorm",
    tgt_ratio=0.25,             # target length = seq_len/4 for train shapes
    source="arXiv:2308.11596; unverified",
)
