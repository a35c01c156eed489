"""Config registry: one module per assigned architecture, and the shape
grid (`repro.configs`, dtypes torch's)."""
from __future__ import annotations

import importlib
from dataclasses import replace

import torch

from ..models.arch import ArchCfg

ARCHS = [
    "gemma2_9b", "yi_34b", "qwen3_14b", "gemma_7b", "qwen2_vl_7b",
    "musicgen_medium", "moonshot_v1_16b_a3b", "llama4_scout_17b_a16e",
    "mamba2_1p3b", "zamba2_2p7b",
]

# canonical ids (CLI uses dashes)
ALIASES = {a.replace("_", "-").replace("-1p3b", "-1.3b")
           .replace("-2p7b", "-2.7b"): a for a in ARCHS}

# (seq_len, global_batch, kind)
SHAPES = {
    "train_4k":    (4096,   256, "train"),
    "prefill_32k": (32768,  32,  "prefill"),
    "decode_32k":  (32768,  128, "decode"),
    "long_500k":   (524288, 1,   "decode"),
}


def get_config(name: str) -> ArchCfg:
    mod = ALIASES.get(name, name).replace("-", "_").replace(
        "1.3b", "1p3b").replace("2.7b", "2p7b")
    return importlib.import_module(f"{__name__}.{mod}").CONFIG


def list_archs():
    return list(ALIASES.keys())


def shape_applicable(cfg: ArchCfg, shape_name: str) -> bool:
    """long_500k only for sub-quadratic (ssm/hybrid) archs."""
    if shape_name == "long_500k":
        return cfg.family in ("ssm", "hybrid")
    return True


def reduce_for_smoke(cfg: ArchCfg) -> ArchCfg:
    """Tiny same-family config for CPU smoke tests."""
    kw = dict(d_model=64, vocab=256, dtype=torch.float32)
    if cfg.family in ("dense", "moe", "hybrid"):
        kw.update(num_heads=4, num_kv_heads=min(cfg.num_kv_heads, 2) or 2,
                  head_dim=16, d_ff=128)
    if cfg.family in ("ssm", "hybrid"):
        kw.update(ssm_state=16, ssm_head_dim=16, ssm_chunk=8)
    if cfg.family == "moe":
        kw.update(num_experts=4, top_k=min(cfg.top_k, 2), d_ff=32,
                  moe_shared_d_ff=32 if cfg.moe_shared_d_ff else 0)
    if cfg.family == "hybrid":
        kw.update(num_layers=4, hybrid_attn_every=2)
    elif cfg.local_global:
        kw.update(num_layers=2, sliding_window=8)
    else:
        kw.update(num_layers=2)
    if cfg.mrope_sections:
        kw.update(mrope_sections=(2, 3, 3))
    return replace(cfg, **kw)


def input_specs(cfg: ArchCfg, shape_name: str, *, dtype=torch.bfloat16):
    """Stand-ins on the `meta` device (shapes and dtypes, no storage) for
    every model input of the given shape, where the JAX package returns
    `ShapeDtypeStruct`s.

    kind == train   -> args for train_step / loss
    kind == prefill -> args for forward
    kind == decode  -> (state, batch) args for serve_step
    """
    from ..models.lm import init_decode_state

    S, B, kind = SHAPES[shape_name]
    S_in = S if kind != "decode" else 1

    def spec(shape, dt):
        return torch.empty(shape, dtype=dt, device="meta")
    batch = {}
    if cfg.frontend != "none":
        batch["embeds"] = spec((B, S_in, cfg.d_model), dtype)
    else:
        batch["tokens"] = spec((B, S_in), torch.int32)
    if cfg.mrope_sections:
        batch["positions"] = spec((3, B, S_in), torch.int32)
    if kind in ("train", "prefill"):
        batch["labels"] = spec((B, S), torch.int32)
        return kind, {"batch": batch}
    state = init_decode_state(cfg, B, S, dtype=dtype, device="meta")
    return kind, {"state": state, "batch": batch}
