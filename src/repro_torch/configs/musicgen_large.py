"""MusicGen-large: decoder-only LM over K=4 EnCodec codebook streams
[arXiv:2306.05284]. The conv codec frontend is stubbed: inputs are the
(B, K, S) token streams; embeddings are summed across codebooks and K
output heads predict the next step of each stream."""
from repro_torch.configs.base import ArchConfig, register

CONFIG = register(ArchConfig(
    name="musicgen-large", family="audio", source="arXiv:2306.05284",
    num_layers=48, d_model=2048, num_heads=32, num_kv_heads=32,
    d_ff=8192, vocab_size=2048,
    num_codebooks=4,
))
