"""Granite-20B-Code: llama-arch MQA (kv=1) code model [arXiv:2405.04324]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="granite-20b", family="dense", source="arXiv:2405.04324",
    num_layers=52, d_model=6144, num_heads=48, num_kv_heads=1,
    d_ff=24576, vocab_size=49152,
))
