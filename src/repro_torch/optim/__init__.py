"""AdamW, the LR schedules and the error-feedback gradient compression of
`repro.optim`, over trees of tensors."""
from .adamw import adamw_init, adamw_update, clip_by_global_norm
from .schedules import cosine_schedule, linear_warmup_cosine
from .compress import ef_compress_update, topk_compress, topk_decompress

__all__ = ["adamw_init", "adamw_update", "clip_by_global_norm",
           "cosine_schedule", "linear_warmup_cosine", "ef_compress_update",
           "topk_compress", "topk_decompress"]
