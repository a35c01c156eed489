"""Yi-34B [arXiv:2403.04652; hf]: llama-architecture GQA, SwiGLU."""
import torch

from ..models.arch import ArchCfg

CONFIG = ArchCfg(
    name="yi-34b", family="dense",
    num_layers=60, d_model=7168, num_heads=56, num_kv_heads=8, head_dim=128,
    d_ff=20480, vocab=64000,
    act="silu", rope_theta=5e6, dtype=torch.bfloat16,
)
