"""Zamba2-7B: Mamba2 backbone with ONE shared attention(+MLP) block applied
every 6 layers — the shared weights are reused at each application
[arXiv:2411.15242]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="zamba2-7b", family="hybrid", source="arXiv:2411.15242",
    num_layers=81, d_model=3584, num_heads=32, num_kv_heads=32, head_dim=112,
    d_ff=14336, vocab_size=32000,
    ssm_state=64, ssm_expand=2, ssm_headdim=64, ssm_conv=4, ssm_chunk=256,
    hybrid_attn_every=6,
))
