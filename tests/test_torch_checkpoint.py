"""The port's msgpack codec, blob store and checkpoints against the JAX
package's `msgpack`-based ones:

- `codec.packb` writes the bytes of `msgpack.packb(obj, use_bin_type=True)`
  for every form the checkpoints and the blob store use (fix, 8-, 16-,
  32- and 64-bit widths of ints, str, bin, arrays and maps; floats, None,
  booleans; a full-width weight matrix), and `codec.unpackb` reads them
  back as `msgpack.unpackb(raw=False)` does;
- a checkpoint written by either package restores in the other bitwise,
  both write the same `state.sha256` and blob for one tree, and
  `tree_digest` equals the JAX package's on a params/opt/rng tree;
- a corrupt newest step rolls back to the newest that loads;
- a dataset shard written by either store is the same file and reads in
  the other; a zstd checkpoint of the JAX package restores in the port
  bitwise, and a malformed zstd blob is a quarantined miss;
- a bare (pre-envelope) body reads as the JAX package reads it: a shard
  is a hit that stays in place, anything else a quarantined miss.

The port compresses with zlib, as the JAX package does where `zstandard`
is not installed (as on the machine with the card). Where it is installed
the JAX package writes zstd, which the port reads with its own decoder
(`runtime/zstd.py`; tests/test_torch_zstd.py holds it against
`zstandard`). The tests that compare the two packages' file bytes run the
JAX package without `zstandard` (`jax_writes_zlib`).
"""
import hashlib
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the host's cores
jax = pytest.importorskip("jax")
msgpack = pytest.importorskip("msgpack")

from repro.core.events import build_event_batch as jax_build  # noqa: E402
from repro.core.model import M4Config as JaxM4Config  # noqa: E402
from repro.runtime import blobstore as jax_blobstore  # noqa: E402
from repro.runtime import checkpoint as jck  # noqa: E402
from repro.train import DatasetStore as JaxStore  # noqa: E402
from repro.train import init_state as jax_init_state  # noqa: E402
from repro_torch.runtime import blobstore, codec  # noqa: E402
from repro_torch.runtime import checkpoint as tck  # noqa: E402
from repro_torch.train import DatasetStore  # noqa: E402
from repro_torch.weights import (params_from_jax, tree_digest,  # noqa: E402
                                 tree_leaves)

TINY = dict(hidden=16, gnn_dim=12, mlp_hidden=8, gnn_layers=2,
            snap_flows=8, snap_links=24)


def _leaf(shape, dtype="<f4", seed=0):
    a = np.random.default_rng(seed).normal(size=shape).astype(dtype)
    return (a.dtype.str, a.shape, a.tobytes())


PAYLOADS = {
    "ints": [0, 1, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1, 2 ** 32,
             2 ** 64 - 1, -1, -32, -33, -128, -129, -32768, -32769,
             -2 ** 31, -2 ** 31 - 1, -2 ** 63],
    "strs": ["", "a" * 31, "b" * 32, "c" * 255, "d" * 256, "e" * 65535,
             "f" * 65536, "flow_init/l0/w", "ü"],
    "bins": [b"", b"x" * 255, b"y" * 256, b"z" * 65535, b"w" * 65536],
    "arrays": [list(range(15)), list(range(16)), tuple(range(65535)),
               list(range(65536)), (), ((),)],
    "maps": [{f"k{i}": i for i in range(n)} for n in (0, 15, 16, 65535,
                                                       65536)],
    "scalars": [None, True, False, 0.5, -1e300, 3.0e-7, float("inf")],
    "checkpoint": {"opt/step": ("<i4", (), np.int32(7).tobytes()),
                   "params/gru1/wh": _leaf((400, 1200)),
                   "params/gnn/0/wf/b": _leaf((300,)),
                   "rng": ("<u4", (2,), np.array([0, 3], np.uint32)
                           .tobytes())},
}


@pytest.mark.parametrize("name", list(PAYLOADS))
def test_codec_writes_msgpack_bytes(name):
    obj = PAYLOADS[name]
    want = msgpack.packb(obj, use_bin_type=True)
    assert codec.packb(obj) == want
    assert codec.unpackb(want) == msgpack.unpackb(want, raw=False)


def test_codec_refuses_what_it_cannot_write():
    with pytest.raises(TypeError):
        codec.packb({"a": np.float32(1.0)})
    with pytest.raises(OverflowError):
        codec.packb(2 ** 64)
    with pytest.raises(ValueError):
        codec.unpackb(msgpack.packb([1, 2])[:-1])
    with pytest.raises(ValueError):
        codec.unpackb(msgpack.packb(1) + b"\x00")


@pytest.fixture
def jax_writes_zlib(monkeypatch):
    """The JAX package as it runs without `zstandard`: zlib blobs."""
    monkeypatch.setattr(jax_blobstore, "zstandard", None)


@pytest.fixture(scope="module")
def jax_tree():
    return jax_init_state(JaxM4Config(**TINY), seed=3).tree()


def _port_tree(jtree):
    """The JAX package's TrainState tree as the port's: tensors for
    params and moments, an int32 tensor step, numpy uint32 rng."""
    t = jax.device_get(jtree)
    return {"params": params_from_jax(t["params"], "cpu"),
            "opt": {"m": params_from_jax(t["opt"]["m"], "cpu"),
                    "v": params_from_jax(t["opt"]["v"], "cpu"),
                    "step": torch.from_numpy(np.array(t["opt"]["step"]))},
            "rng": np.asarray(t["rng"])}


def _assert_trees_bitwise(got, want):
    gl, wl = list(tree_leaves(got)), list(tree_leaves(want))
    assert [p for p, _ in gl] == [p for p, _ in wl]
    for (path, a), (_, b) in zip(gl, wl):
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = np.asarray(b)
        assert a.dtype == b.dtype and a.shape == b.shape, path
        assert a.tobytes() == b.tobytes(), path


def test_tree_digest_equals_jax(jax_tree):
    tree = _port_tree(jax_tree)
    assert tree_digest(tree) == jck.tree_digest(jax_tree)
    assert tree_digest(tree["params"]) == jck.tree_digest(jax_tree["params"])
    tree["params"]["gru1"]["bh"][0] += 1.0
    assert tree_digest(tree) != jck.tree_digest(jax_tree)


def test_jax_checkpoint_restores_in_the_port(jax_tree, jax_writes_zlib,
                                             tmp_path):
    d = str(tmp_path / "ck")
    jck.save(d, 5, jax_tree)
    like = _port_tree(jax_init_state(JaxM4Config(**TINY), seed=0).tree())
    got, step = tck.restore(d, like)
    assert step == 5 and tck.latest_step(d) == 5
    _assert_trees_bitwise(got, jax_tree)
    assert isinstance(got["params"]["gru1"]["wi"], torch.Tensor)
    assert isinstance(got["rng"], np.ndarray)


def test_port_checkpoint_restores_in_jax(jax_tree, tmp_path):
    d = str(tmp_path / "ck")
    tck.save(d, 2, _port_tree(jax_tree))
    like = jax_init_state(JaxM4Config(**TINY), seed=0).tree()
    got, step = jck.restore(d, like)
    assert step == 2
    _assert_trees_bitwise(got, jax_tree)


def test_both_packages_write_the_same_checkpoint(jax_tree, jax_writes_zlib,
                                                 tmp_path):
    dj, dt = str(tmp_path / "jax"), str(tmp_path / "port")
    jck.save(dj, 1, jax_tree)
    tck.save(dt, 1, _port_tree(jax_tree))
    for name in ("state.sha256", "state.msgpack.zst", "COMMITTED"):
        with open(os.path.join(dj, "step_0000000001", name), "rb") as f:
            want = f.read()
        with open(os.path.join(dt, "step_0000000001", name), "rb") as f:
            assert f.read() == want, name


def test_corrupt_newest_step_rolls_back(jax_tree, tmp_path):
    d = str(tmp_path / "ck")
    tree = _port_tree(jax_tree)
    for step in (1, 2, 3, 4):
        tree["opt"]["step"] = torch.tensor(step, dtype=torch.int32)
        tck.save(d, step, tree, keep_last=3)
    assert sorted(os.listdir(d)) == [f"step_{s:010d}" for s in (2, 3, 4)]
    blob = os.path.join(d, "step_0000000004", "state.msgpack.zst")
    raw = bytearray(open(blob, "rb").read())
    raw[10] ^= 0xFF
    open(blob, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="hash mismatch"):
        tck.restore(d, tree)
    got, step, skipped = tck.restore_latest_loadable(d, tree)
    assert step == 3 and int(got["opt"]["step"]) == 3
    assert [s for s, _ in skipped] == [4]
    with pytest.raises(FileNotFoundError):
        tck.restore_latest_loadable(str(tmp_path / "none"), tree)


def test_dataset_shard_is_the_same_file_in_both_stores(jax_writes_zlib,
                                                       tmp_path):
    from repro.data.traffic import sample_scenario
    from repro.net.packetsim import PacketSim
    sc = sample_scenario(0, num_flows=20)
    trace = PacketSim(sc.topo, sc.config).run(sc.generate())
    batch = jax_build(trace, JaxM4Config(**TINY), max_events=32)
    key = "ab" * 32
    jpath = JaxStore(str(tmp_path / "j")).put(key, batch)
    tpath = DatasetStore(str(tmp_path / "t")).put(key, batch)
    with open(jpath, "rb") as fj, open(tpath, "rb") as ft:
        assert fj.read() == ft.read()
    got = DatasetStore(str(tmp_path / "j")).get(key)
    back = JaxStore(str(tmp_path / "t")).get(key)
    for k, v in batch.to_arrays().items():
        assert got.to_arrays()[k].tobytes() == v.tobytes(), k
        assert back.to_arrays()[k].tobytes() == v.tobytes(), k


def test_zstd_checkpoint_raises_naming_zstd(jax_tree, tmp_path):
    """Once a refusal, now a read: the JAX package's zstd checkpoint
    (`zstandard` is installed here) restores in the port bitwise, through
    the port's own decoder."""
    pytest.importorskip("zstandard")
    d = str(tmp_path / "ck")
    jck.save(d, 1, jax_tree)             # zstd: zstandard is installed
    with open(os.path.join(d, "step_0000000001", "state.msgpack.zst"),
              "rb") as f:
        assert f.read(4) == b"\x28\xb5\x2f\xfd"
    like = _port_tree(jax_init_state(JaxM4Config(**TINY), seed=0).tree())
    got, step = tck.restore(d, like)
    assert step == 1
    _assert_trees_bitwise(got, jax_tree)
    got, step, skipped = tck.restore_latest_loadable(d, like)
    assert (step, skipped) == (1, [])
    _assert_trees_bitwise(got, jax_tree)


def test_zstd_blob_raises_naming_zstd(tmp_path):
    """A malformed zstd body raises an IOError naming zstd, and in the
    store it is a quarantined miss; a well-formed one reads."""
    with pytest.raises(IOError, match="zstd"):
        blobstore._decompress(b"\x28\xb5\x2f\xfd" + b"\x00" * 8)
    store = DatasetStore(str(tmp_path))
    path = store._path("cd" * 32)
    os.makedirs(os.path.dirname(path))
    body = b"\x28\xb5\x2f\xfd" + b"\x00" * 8
    with open(path, "wb") as f:
        f.write(blobstore._ENVELOPE_MAGIC + hashlib.sha256(body).digest()
                + body)
    with pytest.raises(IOError, match="zstd"):
        blobstore._decompress(body)
    assert store.get("cd" * 32) is None          # a miss, quarantined
    assert os.path.exists(path + ".corrupt") and not os.path.exists(path)
    zstandard = pytest.importorskip("zstandard")
    raw = codec.packb({"a": 1})
    assert blobstore._decompress(
        zstandard.ZstdCompressor(level=3).compress(raw)) == raw


def test_blob_without_envelope_is_a_quarantined_miss(tmp_path):
    """A bare body is a legacy entry (no envelope), decoded as the JAX
    package decodes it: this one decompresses, but its payload is not a
    dataset shard, so both packages quarantine it. A bare body that is a
    shard is a hit in both, and stays in place
    (tests/test_torch_blobstore_legacy.py holds the result cache)."""
    body = blobstore._compress(codec.packb({"a": 1}))     # not a shard
    for store in (DatasetStore(str(tmp_path / "port")),
                  JaxStore(str(tmp_path / "jax"))):
        path = store._path("ef" * 32)
        os.makedirs(os.path.dirname(path))
        with open(path, "wb") as f:
            f.write(body)
        assert store.get("ef" * 32) is None
        assert os.path.exists(path + ".corrupt") and not os.path.exists(path)


def test_blob_without_envelope_that_is_a_shard_is_a_hit(tmp_path):
    from repro.data.traffic import sample_scenario
    from repro.net.packetsim import PacketSim
    sc = sample_scenario(0, num_flows=20)
    trace = PacketSim(sc.topo, sc.config).run(sc.generate())
    batch = jax_build(trace, JaxM4Config(**TINY), max_events=32)
    store = DatasetStore(str(tmp_path))
    jstore = JaxStore(str(tmp_path))
    path = store._path("ef" * 32)
    os.makedirs(os.path.dirname(path))
    with open(path, "wb") as f:          # a legacy shard, bare zlib
        f.write(blobstore._compress(codec.packb(jstore._encode(batch))))
    for reader in (store, jstore):
        got = reader.get("ef" * 32)
        assert got is not None
        for k, v in batch.to_arrays().items():
            assert got.to_arrays()[k].tobytes() == v.tobytes(), k
    assert os.path.exists(path) and not os.path.exists(path + ".corrupt")
