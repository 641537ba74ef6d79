"""Qwen2-VL-2B: GQA (kv=2) decoder with M-RoPE over a stubbed dynamic-
resolution ViT frontend [arXiv:2409.12191]. ``input_specs`` provides
precomputed patch embeddings (the modality carve-out)."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="qwen2-vl-2b", family="vlm", source="arXiv:2409.12191",
    num_layers=28, d_model=1536, num_heads=12, num_kv_heads=2,
    d_ff=8960, vocab_size=151936,
    mrope=True, vlm_num_patches=256,
))
