"""deepseek-v3-671b [moe] — MLA + 1 shared / 256 routed top-8 fine-grained MoE.

61L d_model=7168 128H d_ff=2048(expert) vocab=129280
[arXiv:2412.19437; hf]

MLA: q_lora_rank=1536, kv_lora_rank=512, qk_nope=128, qk_rope=64, v_head=128.
First 3 layers use a dense FFN (d_ff=18432).  The MTP (multi-token prediction)
auxiliary head is out of scope (DESIGN.md §7).
"""

from repro_torch.configs.base import MLAConfig, ModelConfig, MoEConfig

CONFIG = ModelConfig(
    name="deepseek-v3-671b",
    family="moe",
    num_layers=61,
    d_model=7168,
    num_heads=128,
    num_kv_heads=128,           # MLA decompresses to full heads
    head_dim=128,
    d_ff=2048,                  # routed-expert hidden dim (per assignment)
    vocab_size=129_280,
    mlp_kind="silu_glu",
    rope_theta=10_000.0,
    mla=MLAConfig(
        q_lora_rank=1536,
        kv_lora_rank=512,
        qk_nope_head_dim=128,
        qk_rope_head_dim=64,
        v_head_dim=128,
    ),
    moe=MoEConfig(
        num_experts=256,
        num_shared_experts=1,
        top_k=8,
        d_ff=2048,
        n_dense_layers=3,
        dense_d_ff=18432,
    ),
    source="arXiv:2412.19437; hf",
)
