"""Architecture config dataclass covering the 10 assigned archs, as
`repro.models.arch` (the dtype a `torch.dtype`)."""
from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Tuple

import torch


@dataclass(frozen=True)
class ArchCfg:
    name: str
    family: str                      # dense | moe | ssm | hybrid
    num_layers: int
    d_model: int
    vocab: int
    d_ff: int = 0
    num_heads: int = 0
    num_kv_heads: int = 0
    head_dim: int = 0
    act: str = "silu"                # silu -> SwiGLU, gelu -> GeGLU
    qk_norm: bool = False
    attn_softcap: float = 0.0
    final_softcap: float = 0.0
    sliding_window: int = 0          # window for local layers
    local_global: bool = False       # gemma2 alternating pattern
    sandwich_norm: bool = False      # gemma2 pre+post norms
    rope_theta: float = 10000.0
    mrope_sections: Tuple[int, ...] = ()
    tie_embeddings: bool = False
    embed_scale: bool = False        # gemma: embeds *= sqrt(d_model)
    # MoE
    moe: bool = False
    num_experts: int = 0
    top_k: int = 0
    moe_shared_d_ff: int = 0
    # SSM
    ssm_state: int = 0
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_chunk: int = 128
    # hybrid: one shared attention block applied every N ssm layers (zamba2)
    hybrid_attn_every: int = 0
    # perf knobs of the launch layer; defaults = baseline. attn_batch_axes
    # reshards DTensor q/k/v over those mesh axes (nn.attention);
    # comm_barriers (XLA's optimization barrier) is the identity here
    attn_batch_axes: Tuple[str, ...] = ()
    comm_barriers: bool = False
    # modality frontend (stub): none | vision | audio
    frontend: str = "none"
    num_codebooks: int = 0
    dtype: object = torch.float32

    @property
    def d_inner(self):
        return self.ssm_expand * self.d_model

    @property
    def padded_vocab(self):
        """Embedding/head tables padded to a multiple of 256 (the loss
        reads only [0, vocab))."""
        return self.vocab + ((-self.vocab) % 256)

    @property
    def attn_free(self):
        return self.family == "ssm"

    def with_(self, **kw):
        return replace(self, **kw)

    def _attn_params(self) -> int:
        return self.d_model * self.head_dim * (
            self.num_heads + 2 * self.num_kv_heads) \
            + self.num_heads * self.head_dim * self.d_model

    def _ssm_params(self) -> int:
        d_in_proj = 2 * self.d_inner + 2 * self.ssm_state \
            + self.d_inner // self.ssm_head_dim
        return self.d_model * d_in_proj + self.d_inner * self.d_model

    def param_count(self) -> float:
        """Analytic parameter count N (for MODEL_FLOPS = 6·N·D), the JAX
        package's formula."""
        n = self.vocab * self.d_model  # embed
        if not self.tie_embeddings:
            n += self.vocab * self.d_model
        if self.family in ("dense", "moe"):
            if self.moe:
                ffn = self.num_experts * 3 * self.d_model * self.d_ff \
                    + self.d_model * self.num_experts
                if self.moe_shared_d_ff:
                    ffn += 3 * self.d_model * self.moe_shared_d_ff
            else:
                ffn = 3 * self.d_model * self.d_ff
            n += self.num_layers * (self._attn_params() + ffn)
        elif self.family == "ssm":
            n += self.num_layers * self._ssm_params()
        elif self.family == "hybrid":
            n += self.num_layers * self._ssm_params()
            # one shared attention block + its ffn
            n += self._attn_params() + 3 * self.d_model * self.d_ff
        return float(n)

    def active_param_count(self) -> float:
        """Active params per token (MoE: top_k experts only)."""
        if not self.moe:
            return self.param_count()
        inactive = self.num_layers * (self.num_experts - self.top_k) \
            * 3 * self.d_model * self.d_ff
        return float(self.param_count() - inactive)
