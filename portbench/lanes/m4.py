"""Lane `m4`: the port's m4 backend (`get_backend("m4").run_many`) over
Table-2 scenarios, with m4's weights drawn on the card from the seed
(`portbench/harness/weights.py`), against the plain PyTorch reference of
`portbench/reference/m4.py` (its control: the same products in TF32)."""
from __future__ import annotations

from portbench.harness import flows
from portbench.harness import weights as weights_mod


class Lane(flows.FlowLane):
    @property
    def model(self) -> dict:
        return self.config["model"]

    def weights(self, seed, device):
        return weights_mod.make(self.model, seed, device)

    def backend(self, weights, device):
        from repro_torch.core.model import M4Config
        from repro_torch.sim import get_backend
        keys = ("hidden", "gnn_dim", "mlp_hidden", "gnn_layers", "snap_flows",
                "snap_links", "max_path", "cfg_dim")
        cfg = M4Config(**{k: self.model[k] for k in keys})
        return get_backend("m4", params=weights, cfg=cfg, device=device)

    def reference(self, scenarios, weights, device, *, control=False):
        from portbench.reference import m4
        fct, live = m4.run(scenarios, weights, self.model, device,
                           tf32=control)
        return ([fct[b, :s.num_flows] for b, s in enumerate(scenarios)],
                {"live_edges": live})
