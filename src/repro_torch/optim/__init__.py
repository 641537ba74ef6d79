"""Optimizer and schedules (the port of ``repro.optim``): AdamW with
decoupled weight decay, global-norm clipping, and cosine/linear warmup
schedules. Moments are float32 by default, bf16 through
``AdamWConfig.state_dtype``.
"""

from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     clip_by_global_norm, global_norm)
from repro_torch.optim.schedule import cosine_schedule, linear_schedule

__all__ = ["AdamWConfig", "adamw_init", "adamw_update", "global_norm",
           "clip_by_global_norm", "cosine_schedule", "linear_schedule"]
