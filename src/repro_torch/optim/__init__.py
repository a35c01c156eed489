"""AdamW and the LR schedules of `repro.optim`, over trees of tensors."""
from .adamw import adamw_init, adamw_update, clip_by_global_norm
from .schedules import cosine_schedule, linear_warmup_cosine

__all__ = ["adamw_init", "adamw_update", "clip_by_global_norm",
           "cosine_schedule", "linear_warmup_cosine"]
