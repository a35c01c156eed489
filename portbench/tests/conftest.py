"""Shared pieces of the benchmark's tests: cells cut to sizes that the
CPU's plain paths run in seconds (the widths and the network of the test
configurations are small; the cells' own files are not touched)."""
import copy

import pytest

torch = pytest.importorskip("torch")

from portbench.harness import spec  # noqa: E402

# the port's test files keep to one torch thread: the suite's workers
# share the host's cores
torch.set_num_threads(1)

SMALL_MODEL = dict(hidden=32, gnn_dim=24, mlp_hidden=16, snap_flows=16,
                   snap_links=32)


def small_cell(name: str, trace: bool = False, flows: int = 60,
               batch: int = 3) -> spec.Cell:
    """Cell `name` of the benchmark at a CPU test's size: `batch`
    scenarios of `flows` flows, m4 at small widths, and a fabric of 8
    racks in place of 384."""
    cell = spec.find_cell(spec.load_benchmark(), name, trace)
    cell = copy.deepcopy(cell)
    cell.traffic.update(num_flows=flows, batch=batch)
    cell.config["model"].update(SMALL_MODEL)
    net = cell.config["network"]
    net["num_racks"] = min(net["num_racks"], 8)
    return cell


LM = "zamba2-2.7b.conv-b128"


def smoke_arch(name: str):
    """The port's config `name` at the size of its CPU smoke tests."""
    from repro_torch import configs
    return configs.reduce_for_smoke(configs.get_config(name))


def small_lm_cell(monkeypatch, trace: bool = False, batch: int = 3,
                  prompt: int = 6, steps: int = 10) -> spec.Cell:
    """The LM cell at a CPU test's size: the port's config cut by
    `reduce_for_smoke` (get_config patched to return it, and the cell's
    widths stated to match), `batch` sessions of `prompt` tokens that
    decode `steps` more, all of them sampled."""
    from repro_torch import configs
    cell = copy.deepcopy(spec.find_cell(spec.load_benchmark(), LM, trace))
    small = smoke_arch(cell.config["arch"])
    monkeypatch.setattr(configs, "get_config", lambda name: small)
    for k in cell.config["model"]:
        v = getattr(small, k)
        cell.config["model"][k] = (str(v).removeprefix("torch.")
                                   if isinstance(v, torch.dtype) else v)
    cell.traffic.update(batch=batch, prompt=prompt, steps=steps,
                        sample=batch, prompt_block=2, pool=2)
    return cell


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels have no "
                    "CPU mode")
    return torch.device("cuda")
