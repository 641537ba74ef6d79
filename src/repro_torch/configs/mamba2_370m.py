"""Mamba2-370m: attention-free SSD (state-space duality) stack
[arXiv:2405.21060]. d_ff=0 — blocks are pure Mamba2 mixers."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="mamba2-370m", family="ssm", source="arXiv:2405.21060",
    num_layers=48, d_model=1024, num_heads=0, num_kv_heads=0,
    d_ff=0, vocab_size=50280,
    ssm_state=128, ssm_expand=2, ssm_headdim=64, ssm_conv=4, ssm_chunk=256,
))
