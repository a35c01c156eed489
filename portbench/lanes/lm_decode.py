"""Lane `lm_decode`: the port's LM decode path, as its README shows it
(`repro_torch.configs.get_config`, `models.init_decode_state`,
`models.serve_step`), on batches of sessions that arrive with their
prompts' states, as a decode instance of a disaggregated server
receives them from its prefill instances.

The configuration's file names the port's config (`arch`) and states
its widths (`model`, under `ArchCfg`'s own names); the lane fails the
run where `get_config(arch)` has other values, so the yardstick notices
a config of the program that drifts. It also names its plain reference
(`reference`: portbench/reference/<reference>.py, with `logits(params,
model, constants, tokens, keep, control=, bf16=)` and
`prompt_states(params, model, constants, tokens, chunk=)`), and how each
leaf of the parameter tree is drawn (`init`).

A pool batch is `batch` sessions of `prompt` + `steps` tokens from the
mix's `points_seed`, the same in every run; the weights come from
`--seed`. Set-up makes each session's prompt state with the reference's
chunked forward (`prompt_block` sessions at a time; the port has no path
that fills a decode state from a prompt: its `prefill_step` keeps none),
in the port's state layout and dtype with `prompt` + `steps` slots, and
keeps it in pinned host memory. A call copies that state to the card,
decodes `steps` tokens teacher-forced, one a step, and keeps the logits
of every `keep_every`-th step and of the last on the card; it copies
them to the host once, at its end. Its answers are those logits, its
units the tokens decoded.

The gap of a kept (session, step) is max |got - ref| / max |ref| over
the vocabulary, where ref is the reference's full causal forward over
the session's prompt and decoded tokens, for `sample` sessions drawn
from `--seed`. The numbers, over every call of the window:

- `logits_rel_first`: the largest gap of a session's first decoded
  token, which reads the whole prompt's caches and states;
- `logits_rel_p50`: the median gap of every kept (session, step).

Logits that did not come back, or are not finite, read infinite.
"""
from __future__ import annotations

import math
from pathlib import Path

import numpy as np
import torch

from portbench.harness import lanes, spec

HERE = Path(__file__).resolve().parent


def _dtype_name(v):
    return str(v).removeprefix("torch.") if isinstance(v, torch.dtype) else v


def arch_config(config: dict):
    """The port's `ArchCfg` of `config["arch"]`, checked against every
    width and setting the configuration's file states."""
    from repro_torch.configs import get_config
    cfg = get_config(config["arch"])
    for key, want in config["model"].items():
        got = _dtype_name(getattr(cfg, key))
        if got != want:
            raise RuntimeError(
                f"the port's {config['arch']} has {key} = {got!r}, where the "
                f"benchmark's configuration states {want!r}")
    return cfg


def make_weights(cfg, rules: dict, seed: int, device) -> dict:
    """The parameter tree of `cfg` in the layout of the port's
    `init_params` (read from its shapes on the `meta` device, nothing
    drawn there), drawn on `device` from `seed` by one generator, one
    call a leaf of the stacked tree, in `cfg.dtype`. A leaf is drawn by
    the rule that `rules` gives its key: "zeros", "ones", "normal"
    (standard normal over sqrt of the last axis), Mamba2's own (as
    `mamba_ssm`'s `Mamba2` draws them): "mamba2_A_log" (log of uniform
    [1, 16]) and "mamba2_dt_bias" (softplus's inverse of dt, log-uniform
    in [1e-3, 1e-1]), or, for any other key, "lecun" (standard normal
    truncated to [-2, 2] over sqrt of the next-to-last axis, the
    fan-in)."""
    from repro_torch.models import init_params
    meta = init_params(torch.Generator(), cfg, device="meta")
    g = torch.Generator(device=device).manual_seed(seed % (1 << 63))

    def draw(shape, rule):
        x = torch.empty(shape, dtype=torch.float32, device=device)
        if rule == "zeros":
            return x.zero_()
        if rule == "ones":
            return x.fill_(1.0)
        if rule == "mamba2_A_log":
            return x.uniform_(1.0, 16.0, generator=g).log_()
        if rule == "mamba2_dt_bias":
            dt = x.uniform_(math.log(1e-3), math.log(1e-1),
                            generator=g).exp_()
            return dt + torch.log(-torch.expm1(-dt))
        if rule == "normal":
            return x.normal_(generator=g).div_(math.sqrt(shape[-1]))
        if rule == "lecun":
            torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=g)
            return x.div_(math.sqrt(shape[-2]))
        raise ValueError(f"unknown rule {rule!r}")

    def build(tree, key):
        if isinstance(tree, dict):
            return {k: build(v, k) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(build(v, key) for v in tree)
        return draw(tuple(tree.shape), rules.get(key, "lecun")).to(
            tree.dtype)
    return build(meta, None)


def reference_module(name: str):
    """portbench/reference/<name>.py, beside this lane's folder."""
    return spec.load(HERE.parent / "reference" / f"{name}.py",
                     f"portbench.reference.{name}")


class Lane(lanes.Lane):
    # one traced pass: a call holds some hundred steps of ~3400 launches
    # each, as many operations as a trace can hold and read within a
    # run's time limit
    traced_passes = 1

    def __init__(self, config, traffic):
        super().__init__(config, traffic)
        self.B, self.steps = traffic["batch"], traffic["steps"]
        self.prompt = traffic["prompt"]
        self.max_len = self.prompt + self.steps
        self.keep = sorted(set(range(0, self.steps, traffic["keep_every"]))
                           | {self.steps - 1})
        self.vocab = config["model"]["vocab"]
        self.sample = self.params = None

    def pool(self, seed):
        """The mix's sessions; the sessions the reference reads are drawn
        from `seed`."""
        t = self.traffic
        self.sample = np.sort(np.random.default_rng(seed).choice(
            self.B, min(t["sample"], self.B), replace=False))
        return [np.random.default_rng([t["points_seed"], k]).integers(
            0, self.vocab, (self.B, self.max_len)) for k in range(t["pool"])]

    def weights(self, seed, device):
        self.params = make_weights(arch_config(self.config),
                                   self.config["init"], seed, device)
        return self.params

    def backend(self, weights, device):
        return arch_config(self.config), weights

    def inputs(self, batch, device):
        """(the prompts' states in the port's layout, pinned on the host
        on a card; the tokens to decode, on `device`)."""
        from repro_torch.models import init_decode_state
        cfg = arch_config(self.config)
        ref = reference_module(self.config["reference"])
        shapes = init_decode_state(cfg, self.B, self.max_len, device="meta")
        pinned = torch.device(device).type == "cuda"
        host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=pinned)
                for k, v in shapes.items()}
        host["cache_len"].fill_(self.prompt)
        for k in ("k", "v"):
            host[k][:, :, self.prompt:].zero_()
        G, E = host["conv"].shape[:2]
        tokens = torch.as_tensor(batch, device=device)
        block = self.traffic["prompt_block"]
        for b0 in range(0, self.B, block):
            b1 = min(b0 + block, self.B)
            st = ref.prompt_states(self.params, self.config["model"],
                                   self.config["constants"],
                                   tokens[b0:b1, :self.prompt],
                                   chunk=cfg.ssm_chunk)
            for k in ("conv", "ssm"):
                host[k][:, :, b0:b1].copy_(
                    st[k].reshape((G, E) + st[k].shape[1:]))
            for k in ("k", "v"):
                host[k][:, b0:b1, :self.prompt].copy_(st[k])
            del st
        return host, tokens[:, self.prompt:].contiguous()

    def call(self, backend, inputs, steps=None):
        from repro_torch.models import serve_step
        cfg, params = backend
        host, tokens = inputs
        steps = steps or self.steps
        keep = set(self.keep)
        kept = []
        with torch.no_grad():
            state = {k: v.to(tokens.device, non_blocking=True)
                     for k, v in host.items()}
            for t in range(steps):
                state, logits = serve_step(params, cfg, state,
                                           {"tokens": tokens[:, t:t + 1]})
                if t in keep:
                    kept.append(logits)
            del state
            out = torch.stack(kept, 1)[..., :self.vocab].cpu()
        return out, self.B * steps, self.B

    def warmup(self, backend, inputs):
        """A call of a few steps on one pool batch: every batch and every
        step has the same shapes, and the eager path captures
        nothing."""
        self.call(backend, inputs[0], steps=3)

    def reference(self, tokens, weights, device, *, control=False,
                  bf16=False):
        """The reference's logits of the sampled sessions at the kept
        steps; `bf16` is a witness (`logits`)."""
        ref = reference_module(self.config["reference"])
        rows = torch.as_tensor(tokens[self.sample], device=device)
        out = ref.logits(weights, self.config["model"],
                         self.config["constants"], rows,
                         [self.prompt + t for t in self.keep],
                         control=control, bf16=bf16)
        return out.cpu(), {}

    def gaps(self, outs, refs) -> np.ndarray:
        """max |got - ref| / max |ref| of every kept (sampled session,
        step) of every call: (calls, sessions, kept steps)."""
        rows = []
        for k, got in outs:
            ref = refs[k].double()
            gap = torch.full(ref.shape[:2], math.inf, dtype=torch.float64)
            if got is not None and got.shape[0] == self.B:
                got = got[torch.as_tensor(self.sample)]
            if got is not None and got.shape == ref.shape:
                g = got.double()
                d = (g - ref).abs().amax(-1) / ref.abs().amax(-1)
                ok = torch.isfinite(g).all(-1)
                gap[ok] = d[ok]
            rows.append(gap.numpy())
        return np.stack(rows)

    def numbers(self, outs, refs):
        rel = self.gaps(outs, refs)
        return {"logits_rel_first": float(rel[..., 0].max()),
                "logits_rel_p50": float(np.median(rel))}

    def failed(self, outs, refs):
        """Sessions of the window's calls whose kept logits did not come
        back whole and finite."""
        n = 0
        for _, got in outs:
            if got is None or got.shape[:2] != (self.B, len(self.keep)):
                n += self.B
            else:
                n += int((~torch.isfinite(got).flatten(1).all(1)).sum())
        return n

    def fields(self, pool):
        return {"batch": self.B, "steps": self.steps, "prompt": self.prompt,
                "max_len": self.max_len}
