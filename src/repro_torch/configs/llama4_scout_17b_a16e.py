"""Llama-4-Scout-17B-16E [hf:meta-llama/Llama-4-Scout-17B-16E; unverified]:
MoE 16 experts top-1 + always-on shared expert, GQA kv=8. Early-fusion
multimodality is out of scope for the backbone (text tokens here)."""
import torch

from ..models.arch import ArchCfg

CONFIG = ArchCfg(
    name="llama4-scout-17b-a16e", family="moe",
    num_layers=48, d_model=5120, num_heads=40, num_kv_heads=8, head_dim=128,
    d_ff=8192, vocab=202048,
    act="silu", moe=True, num_experts=16, top_k=1, moe_shared_d_ff=8192,
    rope_theta=5e5, dtype=torch.bfloat16,
)
