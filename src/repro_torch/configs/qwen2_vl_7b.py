"""Qwen2-VL-7B [arXiv:2409.12191; hf]: M-RoPE (16/24/24 bands), GQA kv=4.
Vision frontend is a stub: input_specs() supplies pre-merged patch/text
embeddings (B, S, d_model) per the task spec."""
import torch

from ..models.arch import ArchCfg

CONFIG = ArchCfg(
    name="qwen2-vl-7b", family="dense",
    num_layers=28, d_model=3584, num_heads=28, num_kv_heads=4, head_dim=128,
    d_ff=18944, vocab=152064,
    act="silu", mrope_sections=(16, 24, 24), rope_theta=1e6,
    frontend="vision", dtype=torch.bfloat16,
)
