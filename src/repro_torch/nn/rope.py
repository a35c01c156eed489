"""Rotary position embeddings: standard RoPE and Qwen2-VL M-RoPE, as
`repro.nn.rope` (angles and rotation in float32, cast back to x's
dtype)."""
from __future__ import annotations

import torch


def rope_freqs(head_dim: int, theta=10000.0, *, device=None) -> torch.Tensor:
    exps = torch.arange(0, head_dim, 2, dtype=torch.float32,
                        device=device) / head_dim
    return 1.0 / (theta ** exps)


def _rotate(x: torch.Tensor, ang: torch.Tensor) -> torch.Tensor:
    """x (..., S, H, D) rotated by angles ang (..., S, D/2)."""
    cos, sin = torch.cos(ang)[..., None, :], torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def apply_rope(x: torch.Tensor, positions: torch.Tensor, *,
               theta=10000.0) -> torch.Tensor:
    """x: (..., S, H, D); positions: broadcastable to (..., S)."""
    inv = rope_freqs(x.shape[-1], theta, device=x.device)     # (D/2,)
    return _rotate(x, positions[..., None].float() * inv)


def apply_mrope(x: torch.Tensor, positions_3d: torch.Tensor, sections, *,
                theta=10000.0) -> torch.Tensor:
    """Qwen2-VL multimodal RoPE.

    x: (B, S, H, D); positions_3d: (3, B, S), temporal/height/width ids
    (equal for pure-text tokens); sections: 3 ints summing to D//2, the
    frequency-band split across the three position streams."""
    inv = rope_freqs(x.shape[-1], theta, device=x.device)     # (D/2,)
    ang = positions_3d[..., None].float() * inv               # (3,B,S,D/2)
    bands, start = [], 0
    for i, s in enumerate(sections):
        bands.append(ang[i, ..., start:start + s])
        start += s
    return _rotate(x, torch.cat(bands, dim=-1))
