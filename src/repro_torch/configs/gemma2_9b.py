"""Gemma 2 9B [arXiv:2408.00118; hf]: local+global alternating attention,
logit softcapping, GeGLU, sandwich norms, tied embeddings."""
import torch

from ..models.arch import ArchCfg

CONFIG = ArchCfg(
    name="gemma2-9b", family="dense",
    num_layers=42, d_model=3584, num_heads=16, num_kv_heads=8, head_dim=256,
    d_ff=14336, vocab=256000,
    act="gelu", local_global=True, sliding_window=4096,
    attn_softcap=50.0, final_softcap=30.0, sandwich_norm=True,
    tie_embeddings=True, embed_scale=True, rope_theta=10000.0,
    dtype=torch.bfloat16,
)
