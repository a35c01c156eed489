"""The system under test, one lane per path of the port, found by name.

A traffic mix's `lane` names the file `portbench/lanes/<lane>.py`, which
`lane()` loads as `spec.reader` loads a metric's reader. The file defines
`Lane`, a subclass of `Lane` below, and gives the run everything of its
own: the pool of inputs from the seed, the weights and the backend that
the window drives, one call on a pool batch, the plain reference of a
batch (and its control), the numbers compared, and the fields of the run
that its metrics' readers read. The runner names no lane; a later change
adds one by adding its file. The port is imported only by the lanes,
never by the references of `portbench/reference/`.
"""
from __future__ import annotations

from pathlib import Path
from typing import Dict, List, Tuple

from .spec import ROOT, load


class Lane:
    """What one lane gives the run. `config` and `traffic` are the cell's
    configuration and traffic files."""

    traced_passes = 2      # passes over the pool that a traced run profiles

    def __init__(self, config: dict, traffic: dict):
        self.config = config
        self.traffic = traffic

    def pool(self, seed: int) -> List[object]:
        """The batches a run cycles through, as the reference reads them."""
        raise NotImplementedError

    def weights(self, seed: int, device):
        """The weights from `seed` on `device`, or None."""
        return None

    def backend(self, weights, device):
        """The system under test, built once in set-up."""
        raise NotImplementedError

    def inputs(self, batch, device):
        """The program's form of a pool batch, built in set-up."""
        return batch

    def call(self, backend, inputs) -> Tuple[object, int, int]:
        """One call of the window on one pool batch's inputs: (its answers
        on the host, the units of work done (flows, tokens), the answers
        attempted)."""
        raise NotImplementedError

    def warmup(self, backend, inputs: List[object]) -> None:
        """Set-up's calls, after which the window compiles and captures
        nothing: one on each pool batch, whose shapes may differ."""
        for x in inputs:
            self.call(backend, x)

    def release(self, backend) -> None:
        """Free what the program keeps beyond `backend` before the
        reference runs."""

    def reference(self, batch, weights, device, *, control=False):
        """(the plain reference's answers for a pool batch, the counts its
        readers read); `control` computes them in the precision below the
        configuration's, in the program's place."""
        raise NotImplementedError

    def numbers(self, outs, refs) -> Dict[str, float]:
        """The numbers compared: `outs` [(pool index, answers)] of every
        call, `refs` pool index -> the reference's answers."""
        raise NotImplementedError

    def quantiles(self, outs, refs) -> Dict[str, object]:
        """Where the numbers compared come from, for the calibration's
        records: quantiles of the gaps behind them."""
        return {}

    def failed(self, outs, refs) -> int:
        """Answers of the window that came back incomplete or not
        finite."""
        raise NotImplementedError

    def fields(self, pool) -> dict:
        """The run's attributes that this lane's readers read."""
        return {}


def lane(traffic: dict, config: dict, root: Path = ROOT) -> Lane:
    """The lane that the traffic mix names: `Lane` of
    portbench/lanes/<lane>.py."""
    name = traffic["lane"]
    path = root / "portbench" / "lanes" / f"{name}.py"
    if not path.is_file():
        raise ValueError(f"unknown lane {name!r}: no {path}")
    return load(path, f"portbench.lanes.{name}").Lane(config, traffic)
