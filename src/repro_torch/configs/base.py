"""Architecture + run configuration schema (a copy of ``repro.configs.base``).

One :class:`ArchConfig` per architecture lives in
``repro_torch/configs/<id>.py`` with the exact public-literature spec; tests
use :func:`ArchConfig.reduced` (≤2 layers, d_model ≤ 512, ≤4 experts).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

__all__ = ["ArchConfig", "InputShape", "INPUT_SHAPES", "register", "get_config",
           "list_configs"]


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    # identity ---------------------------------------------------------------
    name: str
    family: str                     # dense | moe | ssm | hybrid | vlm | audio
    source: str = ""                # citation

    # trunk ------------------------------------------------------------------
    num_layers: int = 2
    d_model: int = 256
    num_heads: int = 4
    num_kv_heads: int = 4
    head_dim: Optional[int] = None  # default: d_model // num_heads
    d_ff: int = 1024
    vocab_size: int = 32000
    norm_eps: float = 1e-6
    rope_theta: float = 10_000.0
    tie_embeddings: bool = False

    # attention pattern --------------------------------------------------------
    attention: str = "full"         # full | local_global | sliding
    sliding_window: int = 0         # window for sliding / local layers
    local_global_ratio: int = 0     # gemma3: N local per 1 global

    # MLA (deepseek) -----------------------------------------------------------
    mla: bool = False
    kv_lora_rank: int = 0
    qk_nope_dim: int = 128
    qk_rope_dim: int = 64
    v_head_dim: int = 128

    # M-RoPE (qwen2-vl) ----------------------------------------------------------
    mrope: bool = False
    vlm_num_patches: int = 256      # stubbed vision prefix length

    # MoE ----------------------------------------------------------------------
    num_experts: int = 0
    top_k: int = 0
    num_shared_experts: int = 0
    moe_dense_residual: bool = False   # arctic: dense FFN in parallel
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # SSM (mamba2) ---------------------------------------------------------------
    ssm_state: int = 0
    ssm_expand: int = 2
    ssm_headdim: int = 64
    ssm_conv: int = 4
    ssm_chunk: int = 64
    hybrid_attn_every: int = 0      # zamba2: shared attn block every N layers

    # audio (musicgen) -------------------------------------------------------------
    num_codebooks: int = 0

    # --------------------------------------------------------------------------
    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or (self.d_model // self.num_heads)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm"

    def reduced(self, **overrides) -> "ArchConfig":
        """Smoke-test variant: same family/wiring, tiny sizes."""
        small = dict(
            num_layers=2,
            d_model=min(self.d_model, 256),
            num_heads=min(self.num_heads, 4),
            num_kv_heads=max(1, min(self.num_kv_heads, 2)),
            head_dim=64 if self.head_dim else None,
            d_ff=min(self.d_ff, 512) if self.d_ff else 0,
            vocab_size=min(self.vocab_size, 512),
            sliding_window=min(self.sliding_window, 16) if self.sliding_window else 0,
            vlm_num_patches=8 if self.mrope else self.vlm_num_patches,
        )
        if self.num_experts:
            small.update(num_experts=4, top_k=min(self.top_k, 2),
                         num_shared_experts=min(self.num_shared_experts, 1))
        if self.mla:
            small.update(kv_lora_rank=32, qk_nope_dim=32, qk_rope_dim=16,
                         v_head_dim=32)
        if self.ssm_state:
            small.update(ssm_state=16, ssm_headdim=16, ssm_chunk=8)
        if self.hybrid_attn_every:
            small.update(num_layers=max(4, 2 * self.hybrid_attn_every // 3))
        if self.local_global_ratio:
            small.update(num_layers=4)
        small.update(overrides)
        return dataclasses.replace(self, **small)


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    mode: str  # train | prefill | decode


INPUT_SHAPES = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}

_REGISTRY = {}


def register(cfg: ArchConfig) -> ArchConfig:
    _REGISTRY[cfg.name] = cfg
    return cfg


def get_config(name: str) -> ArchConfig:
    if not _REGISTRY:
        _load_all()
    if name not in _REGISTRY:
        raise KeyError(f"no config {name!r}: the registry has "
                       f"{sorted(_REGISTRY)}")
    return _REGISTRY[name]


def list_configs():
    if not _REGISTRY:
        _load_all()
    return sorted(_REGISTRY)


def _load_all():
    # Importing each module runs its register() call.
    from repro_torch.configs import (  # noqa: F401
        arctic_480b, deepseek_v2_lite_16b, gemma3_4b, granite_20b, llama3_8b,
        mamba2_370m, musicgen_large, phi4_mini_3_8b, qwen2_vl_2b, zamba2_7b,
    )
