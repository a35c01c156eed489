"""Legacy blobs (no RBS1 envelope) read alike in the port and in the JAX
package: the directories of the sweep cache, the dataset store and the
fleet's coordination are shared between them, so a port run over an old
cache must not destroy what the reference would serve.

- A legacy entry written as `tests/test_runtime.py` writes one (the bare
  compressed payload, zlib or zstd) is a hit in the port's `ResultCache`
  and `DatasetStore`, and the file stays in place: the JAX package still
  reads it afterwards.
- A legacy body that does not decode (not compressed, truncated, or a
  payload that is not an entry of the store) is a quarantined miss in
  both packages: `<path>.corrupt`, no `<path>`.
"""
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the host's cores
msgpack = pytest.importorskip("msgpack")

from repro.runtime import blobstore as jax_blobstore  # noqa: E402
from repro.scenarios.cache import ResultCache as JaxCache  # noqa: E402
from repro.sim import SimResult as JaxResult  # noqa: E402
from repro_torch.runtime import blobstore, codec  # noqa: E402
from repro_torch.scenarios.cache import ResultCache  # noqa: E402

KEY = "ab" * 32


def _result():
    return JaxResult(fcts=np.arange(8, dtype=np.float64) * 1e-6,
                     slowdowns=np.linspace(1.0, 3.0, 8), wall_time=0.5,
                     backend="stub")


def _compress(raw, kind):
    if kind == "zlib":
        import zlib
        return zlib.compress(raw, 6)
    zstandard = pytest.importorskip("zstandard")
    return zstandard.ZstdCompressor(level=3).compress(raw)


def _write(store, body):
    path = store._path(KEY)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "wb") as f:
        f.write(body)
    return path


@pytest.mark.parametrize("kind", ["zlib", "zstd"])
def test_legacy_result_entry_is_a_hit_and_stays(tmp_path, kind):
    """JAX writes a legacy entry; the port's `get` returns JAX's result,
    the file stays, and JAX's `get` still returns it afterwards."""
    jstore = JaxCache(str(tmp_path))
    res = _result()
    raw = msgpack.packb(jstore._encode(res), use_bin_type=True)
    path = _write(jstore, _compress(raw, kind))
    got = ResultCache(str(tmp_path)).get(KEY)
    assert got is not None
    assert got.fcts.tobytes() == res.fcts.tobytes()
    assert got.slowdowns.tobytes() == res.slowdowns.tobytes()
    assert (got.wall_time, got.backend) == (res.wall_time, res.backend)
    assert os.path.exists(path) and not os.path.exists(path + ".corrupt")
    back = jstore.get(KEY)
    assert back is not None and back.fcts.tobytes() == res.fcts.tobytes()


def test_legacy_body_of_the_port_codec_is_a_hit_in_both(tmp_path):
    """A bare zlib body made by the port's own codec and `_compress`
    (the machine with the card has no msgpack) reads in both packages."""
    store = ResultCache(str(tmp_path))
    res = _result()
    path = _write(store, blobstore._compress(codec.packb(
        store._encode(res))))
    for reader in (store, JaxCache(str(tmp_path)), store):
        got = reader.get(KEY)
        assert got is not None and got.fcts.tobytes() == res.fcts.tobytes()
    assert os.path.exists(path)


def _bad_bodies():
    good = blobstore._compress(codec.packb({"fcts": b"", "dtype": "<f8"}))
    return {
        "not_compressed": b"\x00\x01legacy" * 4,
        "truncated_zlib": blobstore._compress(codec.packb({"a": 1}))[:-3],
        "not_an_entry": good,                      # no slowdowns etc.
        "bad_magic_envelope": b"RBS0" + bytes(32) + good,
    }


@pytest.mark.parametrize("name", sorted(_bad_bodies()))
def test_legacy_body_that_does_not_decode_is_quarantined_in_both(tmp_path,
                                                                 name):
    body = _bad_bodies()[name]
    for sub, store in (("port", ResultCache(str(tmp_path / "port"))),
                       ("jax", JaxCache(str(tmp_path / "jax")))):
        path = _write(store, body)
        assert store.get(KEY) is None, sub
        assert os.path.exists(path + ".corrupt"), sub
        assert not os.path.exists(path), sub


def test_enveloped_entries_read_alike(tmp_path):
    """An enveloped entry written by either package reads in the other,
    so the legacy path changes nothing for current entries."""
    res = _result()
    port, jax_ = ResultCache(str(tmp_path)), JaxCache(str(tmp_path))
    port.put(KEY, res)
    with open(port._path(KEY), "rb") as f:
        assert f.read(4) == jax_blobstore._ENVELOPE_MAGIC
    assert jax_.get(KEY).fcts.tobytes() == res.fcts.tobytes()
    jax_.put("cd" * 32, res)
    assert port.get("cd" * 32).slowdowns.tobytes() == \
        res.slowdowns.tobytes()
