"""Zamba2-2.7B [arXiv:2411.15242; hf]: Mamba2 backbone with ONE shared
attention block (shared weights, per-site KV cache) applied every 6 layers.
Hybrid -> runs long_500k."""
import torch

from ..models.arch import ArchCfg

CONFIG = ArchCfg(
    name="zamba2-2.7b", family="hybrid",
    num_layers=54, d_model=2560, num_heads=32, num_kv_heads=32, head_dim=80,
    d_ff=10240, vocab=32000,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    hybrid_attn_every=6, dtype=torch.bfloat16,
)
