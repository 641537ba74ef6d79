"""Snowflake Arctic-480B: 128 experts top-2 MoE with a parallel dense
residual FFN [hf:Snowflake/snowflake-arctic-base]."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="arctic-480b", family="moe",
    source="hf:Snowflake/snowflake-arctic-base",
    num_layers=35, d_model=7168, num_heads=56, num_kv_heads=8,
    d_ff=4864, vocab_size=32000,
    num_experts=128, top_k=2, moe_dense_residual=True,
))
