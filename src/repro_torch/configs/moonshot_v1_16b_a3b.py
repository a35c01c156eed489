"""Moonlight-16B-A3B [hf:moonshotai/Moonlight-16B-A3B; hf]: MoE 64 experts
top-6, per-expert d_ff=1408, 16 heads MHA-ish (kv=16)."""
import torch

from ..models.arch import ArchCfg

CONFIG = ArchCfg(
    name="moonshot-v1-16b-a3b", family="moe",
    num_layers=48, d_model=2048, num_heads=16, num_kv_heads=16, head_dim=128,
    d_ff=1408, vocab=163840,
    act="silu", moe=True, num_experts=64, top_k=6, dtype=torch.bfloat16,
)
