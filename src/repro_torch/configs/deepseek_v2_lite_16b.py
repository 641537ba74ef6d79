"""DeepSeek-V2-Lite-16B: MLA (kv_lora=512) + MoE 64 routed top-6, 2 shared
experts [arXiv:2405.04434].

Assignment-spec note: the assignment line lists both "64e top-6" and
"2 shared+160 routed"; 160 routed experts belongs to full DeepSeek-V2 —
we follow the primary V2-Lite spec (64 routed, 2 shared, top-6)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="deepseek-v2-lite-16b", family="moe", source="arXiv:2405.04434",
    num_layers=27, d_model=2048, num_heads=16, num_kv_heads=16,
    d_ff=1408, vocab_size=102400,
    mla=True, kv_lora_rank=512, qk_nope_dim=128, qk_rope_dim=64,
    v_head_dim=128,
    num_experts=64, top_k=6, num_shared_experts=2,
))
