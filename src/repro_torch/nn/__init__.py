from .attention import (AttnCfg, attn_decode, attn_forward, attn_init,
                        causal_mask)
from .layers import (embedding, embedding_init, gru_cell, gru_init,
                     layernorm, layernorm_init, lecun_normal, linear,
                     linear_init, mlp, mlp_init, normal_init, rmsnorm,
                     rmsnorm_init, uniform_scale_init)
from .moe import MoECfg, moe_forward, moe_init
from .rope import apply_mrope, apply_rope
from .ssm import SSMCfg, ssm_decode, ssm_forward, ssm_init

__all__ = ["AttnCfg", "MoECfg", "SSMCfg", "apply_mrope", "apply_rope",
           "attn_decode", "attn_forward", "attn_init", "causal_mask",
           "embedding", "embedding_init", "gru_cell", "gru_init",
           "layernorm", "layernorm_init", "lecun_normal", "linear",
           "linear_init", "mlp", "mlp_init", "moe_forward", "moe_init",
           "normal_init", "rmsnorm", "rmsnorm_init", "ssm_decode",
           "ssm_forward", "ssm_init", "uniform_scale_init"]
