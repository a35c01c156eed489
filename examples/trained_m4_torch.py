"""The benchmark's trained m4 for the port's examples (closed_loop_torch.py,
simulate_collectives_torch.py): `repro_torch.train.recipe.trained_m4`
with the examples' folders. The first call trains into
results/m4_ckpt_torch; later calls load it. `ckpt_dir` takes a
checkpoint of either package (results/m4_ckpt is the JAX benchmarks')."""
import os

from repro_torch.train import recipe

_RESULTS = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..",
                        "results")


def trained_m4(ckpt_dir=None, device="cuda", log=print):
    """(params on `device`, cfg) of the benchmark's m4 in `ckpt_dir`
    (default results/m4_ckpt_torch), trained there first when missing."""
    return recipe.trained_m4(ckpt_dir or os.path.join(_RESULTS,
                                                      "m4_ckpt_torch"),
                             os.path.join(_RESULTS, "train_data"), device,
                             log=log)
