"""The port's launch layer (`repro_torch.launch.{mesh,sharding,dryrun,
roofline}`, `runtime.resilience.remesh`) on the CPU, over a fake process
group of 512 ranks:

- `param_spec` equal to JAX's on every leaf of all ten archs' full trees
  (shapes only: `jax.eval_shape` against the port's `meta` init);
- `batch_spec` and `decode_state_spec` equal to JAX's on each arch's
  `input_specs` of every shape, on the 16x16 and 2x16x16 meshes;
- `remesh` onto a (2, 2) mesh and back onto (4, 1): placements and local
  shapes;
- the census on a known answer: a column-sharded matmul, then
  `full_tensor()`, is one all-gather of the bytes worked out by hand;
- a dense arch's train cell at `reduce_for_smoke` on a (2, 2) mesh: the
  record keys examples/simulate_collectives.py reads, and JAX's others;
  the hybrid's and a GQA arch's train and decode cells, and the hybrid's
  B 1 decode (the SSD scan, attention and the lookup per shard); a
  parameter leaf left plain fails the cell;
- the roofline's two-depth extrapolation equal to a direct count at full
  depth (smoke size).
"""
import json
import math
import types

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the host's cores
jax = pytest.importorskip("jax")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402
from torch.distributed.tensor import (Replicate, Shard,  # noqa: E402
                                      distribute_tensor)

from repro import configs as jconfigs  # noqa: E402
from repro.launch import sharding as jsharding  # noqa: E402
from repro.models import lm as jlm  # noqa: E402
from repro_torch import configs  # noqa: E402
from repro_torch.launch import dryrun, roofline, sharding  # noqa: E402
from repro_torch.launch.mesh import (init_fake_group,  # noqa: E402
                                     make_debug_mesh, make_production_mesh)
from repro_torch.models import lm  # noqa: E402
from repro_torch.runtime.resilience import remesh  # noqa: E402
from repro_torch.weights import tree_leaves  # noqa: E402

ARCHS = configs.list_archs()
HLO_KINDS = {"all-reduce", "all-gather", "reduce-scatter", "all-to-all",
             "collective-permute"}


@pytest.fixture(scope="module", autouse=True)
def fake_group():
    # one group per process, left up for the worker's later files: DTensor
    # caches redistribution plans by mesh shape, and a plan cached before
    # a destroy names process groups that a new group does not have
    init_fake_group()


def _jax_paths(tree, fn):
    """{path: spec as a tuple} of a JAX tree, paths as the port writes
    them."""
    out = {}
    for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        out["/".join(keys)] = fn(path, leaf)
    return out


def _jax_specs(spec_tree):
    return {p: tuple(s) for p, s in _jax_paths_leaves(spec_tree)}


def _jax_paths_leaves(spec_tree):
    from jax.sharding import PartitionSpec as P
    flat = jax.tree_util.tree_flatten_with_path(
        spec_tree, is_leaf=lambda x: isinstance(x, P))[0]
    for path, spec in flat:
        keys = [str(getattr(k, "key", getattr(k, "idx", k))) for k in path]
        yield "/".join(keys), spec


@pytest.mark.parametrize("arch", ARCHS)
def test_param_spec_equals_jax_on_every_leaf(arch):
    jcfg = jconfigs.get_config(arch)
    abstract = jax.eval_shape(
        lambda: jlm.init_params(jax.random.PRNGKey(0), jcfg))
    want = _jax_paths(abstract,
                      lambda p, leaf: tuple(jsharding.param_spec(p, leaf)))
    params = lm.init_params(torch.Generator(), configs.get_config(arch),
                            device="meta")
    got = {path: sharding.param_spec(path, leaf)
           for path, leaf in tree_leaves(params)}
    assert got == want
    assert all(leaf.is_meta for _, leaf in tree_leaves(params))


@pytest.mark.parametrize("multi_pod", [False, True])
def test_batch_and_decode_specs_equal_jax(multi_pod):
    mesh = make_production_mesh(multi_pod=multi_pod)
    names = mesh.mesh_dim_names
    jmesh = types.SimpleNamespace(axis_names=names, shape=dict(
        zip(names, mesh.shape)))
    for arch in ARCHS:
        cfg, jcfg = configs.get_config(arch), jconfigs.get_config(arch)
        for shape, (S, B, kind) in configs.SHAPES.items():
            _, specs = configs.input_specs(cfg, shape)
            _, jspecs = jconfigs.input_specs(jcfg, shape)
            # both trees are flat dicts of specs
            got = sharding.batch_spec(specs["batch"], mesh, B)
            assert got == _jax_specs(jsharding.batch_spec(
                jspecs["batch"], jmesh, B)), (arch, shape)
            if kind == "decode":
                got = sharding.decode_state_spec(specs["state"], mesh, cfg,
                                                 B)
                assert got == _jax_specs(jsharding.decode_state_spec(
                    jspecs["state"], jmesh, jcfg, B)), (arch, shape)


def test_placements_of_specs():
    mesh = make_production_mesh(multi_pod=True)
    P = sharding.P
    assert sharding.placements(P(), mesh) == [Replicate()] * 3
    assert sharding.placements(P(("pod", "data"), None, "model"), mesh) == [
        Shard(0), Shard(0), Shard(2)]
    with pytest.raises(ValueError):
        sharding.placements(P(("data", "pod")), mesh)


def test_remesh_grow_and_shrink():
    cfg = configs.reduce_for_smoke(configs.get_config("zamba2-2.7b"))
    params = lm.init_params(torch.Generator().manual_seed(0), cfg)
    for mesh in (make_debug_mesh(2, 2), make_debug_mesh(4, 1)):
        params = remesh(params, sharding.param_spec, mesh)
        for path, leaf in tree_leaves(params):
            want = sharding.placements(sharding.param_spec(path, leaf),
                                       mesh)
            assert list(leaf.placements) == want, path
            assert leaf.device_mesh is mesh
            local = list(leaf.shape)
            for i, p in enumerate(want):
                if p.is_shard():
                    local[p.dim] = math.ceil(local[p.dim] / mesh.size(i))
            assert list(leaf.to_local().shape) == local, path


def test_census_counts_one_all_gather_of_a_column_sharded_matmul():
    mesh = make_debug_mesh(2, 2)
    with FakeTensorMode():
        x = distribute_tensor(torch.empty(8, 16), mesh,
                              [Replicate(), Replicate()])
        w = distribute_tensor(torch.empty(16, 32), mesh,
                              [Replicate(), Shard(1)])
        census = dryrun.Census()
        with census:
            y = (x @ w).full_tensor()
    assert tuple(y.shape) == (8, 32)
    # the (8, 32) float32 result, gathered over `model` on every rank
    assert census.ops == 1
    assert census.kinds == {"all-gather": 8 * 32 * 4}
    assert census.total == 1024


def test_dense_train_cell_record(tmp_path):
    arch, shape = "qwen3-14b", "train_4k"
    cfg = configs.reduce_for_smoke(configs.get_config(arch))
    rec = dryrun.lower_cell(arch, shape, False, verbose=False, cfg=cfg,
                            mesh=make_debug_mesh(2, 2))
    path = tmp_path / f"{arch}_{shape}_2x2.json"
    path.write_text(json.dumps(rec, indent=1, default=str))
    rec = json.loads(path.read_text())
    # what examples/simulate_collectives.py reads
    assert (rec["arch"], rec["shape"]) == (arch, shape)
    assert isinstance(rec["collective_ops"], int) and rec["collective_ops"]
    assert set(rec["collective_kinds"]) <= HLO_KINDS
    assert all(isinstance(b, int) and b > 0
               for b in rec["collective_kinds"].values())
    assert rec["collective_bytes"] == sum(rec["collective_kinds"].values())
    # and JAX's other keys
    assert rec["mesh"] == "2x2" and rec["devices"] == 4
    assert rec["kind"] == "train" and (rec["seq"], rec["batch"]) == (4096,
                                                                      256)
    assert rec["flops"] > 0 and rec["bytes_accessed"] is None
    assert "error" in rec["memory"] and rec["lower_s"] >= 0


@pytest.mark.parametrize("arch,shape", [
    ("zamba2-2.7b", "train_4k"), ("zamba2-2.7b", "decode_32k"),
    ("zamba2-2.7b", "long_500k"),       # B 1: the batch stays whole
    ("gemma2-9b", "train_4k"), ("gemma2-9b", "decode_32k")])
def test_per_shard_layers_trace(arch, shape):
    # SSD chunks of 1024: the scan's op count falls with the chunks of S
    cfg = configs.reduce_for_smoke(configs.get_config(arch)).with_(
        ssm_chunk=1024)
    census, flops, _ = dryrun.trace_cell(cfg, shape, make_debug_mesh(2, 2))
    assert census.ops and set(census.kinds) <= HLO_KINDS and flops > 0


def test_a_parameter_left_plain_fails_the_cell(monkeypatch):
    def leaky(tree, rule, mesh):
        out = remesh(tree, rule, mesh)
        out["final_norm"]["scale"] = out["final_norm"]["scale"].to_local()
        return out

    monkeypatch.setattr(dryrun, "remesh", leaky)
    cfg = configs.reduce_for_smoke(configs.get_config("qwen3-14b"))
    with pytest.raises(TypeError, match="final_norm/scale"):
        dryrun.trace_cell(cfg, "train_4k", make_debug_mesh(2, 2))


def test_roofline_extrapolation_equals_a_full_depth_count():
    cfg = configs.reduce_for_smoke(configs.get_config("yi-34b")).with_(
        num_layers=4)
    mesh = make_debug_mesh(2, 2)
    rec = roofline.analyze_cell("yi-34b", "train_4k", log=lambda *a: None,
                                cfg=cfg, mesh=mesh)
    assert rec["depths_probed"] == [1, 2]
    flops, nbytes, coll = roofline._lower_unrolled(cfg, "train_4k", 4, mesh)
    assert rec["flops_dev"] == pytest.approx(flops, rel=1e-12)
    assert rec["coll_bytes_dev"] == pytest.approx(coll, rel=1e-12)
    # the bytes hold one term quadratic in depth, which two depths cannot
    # extrapolate: the backward of each layer's slice of the stacked
    # weights writes a gradient of the whole stack
    assert rec["bytes_dev"] == pytest.approx(nbytes, rel=1e-6)
    terms = {"compute": rec["t_compute_s"], "memory": rec["t_memory_s"],
             "collective": rec["t_collective_s"]}
    assert rec["dominant"] == max(terms, key=terms.get)
    assert rec["t_compute_s"] == flops / roofline.PEAK_FLOPS
