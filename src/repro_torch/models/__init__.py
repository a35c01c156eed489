"""The decoder LM of the assigned architectures (`repro.models`)."""
from .arch import ArchCfg
from .lm import (forward, init_decode_state, init_params, loss_fn,
                 prefill_step, serve_step)

__all__ = ["ArchCfg", "forward", "init_decode_state", "init_params",
           "loss_fn", "prefill_step", "serve_step"]
