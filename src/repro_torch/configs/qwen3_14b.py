"""Qwen3-14B [hf:Qwen/Qwen3-8B family; hf]: GQA kv=8 with per-head qk-norm."""
import torch

from ..models.arch import ArchCfg

CONFIG = ArchCfg(
    name="qwen3-14b", family="dense",
    num_layers=40, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=17408, vocab=151936,
    act="silu", qk_norm=True, rope_theta=1e6, dtype=torch.bfloat16,
)
