"""MusicGen-medium [arXiv:2306.05284; hf]: decoder-only over EnCodec tokens
(4 codebooks, vocab 2048/codebook). The EnCodec frontend is a stub: input
specs supply summed codebook frame embeddings. Deviation noted in DESIGN.md:
we keep the GLU FFN substrate (MusicGen uses a plain MLP) and RoPE (MusicGen
uses sinusoidal) — structure and cost are equivalent at the system level."""
import torch

from ..models.arch import ArchCfg

CONFIG = ArchCfg(
    name="musicgen-medium", family="dense",
    num_layers=48, d_model=1536, num_heads=24, num_kv_heads=24, head_dim=64,
    d_ff=6144, vocab=2048,
    act="gelu", frontend="audio", num_codebooks=4, dtype=torch.bfloat16,
)
