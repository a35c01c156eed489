"""Mamba2-1.3B [arXiv:2405.21060; unverified]: attention-free SSD blocks,
d_state=128, head_dim=64, expand=2. Sub-quadratic -> runs long_500k."""
import torch

from ..models.arch import ArchCfg

CONFIG = ArchCfg(
    name="mamba2-1.3b", family="ssm",
    num_layers=48, d_model=2048, vocab=50280,
    ssm_state=128, ssm_head_dim=64, ssm_expand=2, ssm_chunk=256,
    tie_embeddings=True, dtype=torch.bfloat16,
)
