"""Gemma-3-4B: 5:1 local:global attention, 128k ctx, 262k vocab
[hf:google/gemma-3-1b-pt]. Local layers use a 1024-token sliding window
(ring caches); every 6th layer is global full attention."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="gemma3-4b", family="dense", source="hf:google/gemma-3-1b-pt",
    num_layers=34, d_model=2560, num_heads=8, num_kv_heads=4, head_dim=256,
    d_ff=10240, vocab_size=262144, rope_theta=1_000_000.0,
    attention="local_global", local_global_ratio=5, sliding_window=1024,
))
