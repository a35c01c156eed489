"""Gemma 7B [arXiv:2403.08295; hf]: GeGLU, head_dim=256, kv=16 (MHA)."""
import torch

from ..models.arch import ArchCfg

CONFIG = ArchCfg(
    name="gemma-7b", family="dense",
    num_layers=28, d_model=3072, num_heads=16, num_kv_heads=16, head_dim=256,
    d_ff=24576, vocab=256000,
    act="gelu", tie_embeddings=True, embed_scale=True, rope_theta=10000.0,
    dtype=torch.bfloat16,
)
