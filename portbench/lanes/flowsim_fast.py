"""Lane `flowsim_fast`: the port's flowSim baseline
(`get_backend("flowsim_fast").run_many`) over Table-2 scenarios, no
weights, against the numpy reference of `portbench/reference/flowsim.py`
(its control: every float32 result rounded to bfloat16)."""
from __future__ import annotations

import numpy as np

from portbench.harness import flows


class Lane(flows.FlowLane):
    def backend(self, weights, device):
        from repro_torch.sim import get_backend
        return get_backend("flowsim_fast", device=device)

    def reference(self, scenarios, weights, device, *, control=False):
        from portbench.reference import flowsim
        fct_abs, rounds = flowsim.run(scenarios, control=control)
        # the backend reports completion minus arrival, in float64
        return ([fct_abs[b, :s.num_flows].astype(np.float64) - s.t_arrival
                 for b, s in enumerate(scenarios)], {"rounds": rounds})
