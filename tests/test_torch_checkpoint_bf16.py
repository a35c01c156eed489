"""bfloat16 leaves in the port's checkpoints and `tree_digest`, against
the JAX package's:

- a JAX checkpoint holding a bfloat16 leaf restores in the port bitwise
  (as `torch.bfloat16`), and a port checkpoint of a `torch.bfloat16`
  tensor restores in the JAX package bitwise;
- both packages write the same `state.sha256` for one tree (the JAX
  package run without `zstandard`, as on the machine with the card), and
  `tree_digest` is equal for the JAX tree, its numpy view and the port's
  tensors;
- the port does all of it without importing `ml_dtypes` or `jax`.

The values include infinities, a negative zero, bfloat16's largest
finite value and a subnormal, so any rounding or flush on the way shows.
"""
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the host's cores
jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.runtime import blobstore as jax_blobstore  # noqa: E402
from repro.runtime import checkpoint as jck  # noqa: E402
from repro_torch.runtime import checkpoint as tck  # noqa: E402
from repro_torch.weights import tree_digest  # noqa: E402

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture
def jax_writes_zlib(monkeypatch):
    monkeypatch.setattr(jax_blobstore, "zstandard", None)


def _values(seed=0):
    x = np.random.default_rng(seed).normal(size=(4, 6)).astype(np.float32)
    x.flat[:5] = [np.inf, -np.inf, -0.0, 3.3895314e38, 9.18e-41]
    return x


def _trees(seed=0):
    """The same tree as JAX arrays and as the port's tensors."""
    x = _values(seed)
    jt = {"w": jnp.asarray(x, jnp.bfloat16),
          "opt": {"mu": jnp.asarray(x[::-1].copy(), jnp.bfloat16),
                  "step": jnp.array(7, jnp.int32)},
          "bias": jnp.arange(5, dtype=jnp.float32)}
    words = lambda a: torch.from_numpy(  # noqa: E731
        np.asarray(a).view(np.int16).copy()).view(torch.bfloat16)
    tt = {"w": words(jt["w"]),
          "opt": {"mu": words(jt["opt"]["mu"]),
                  "step": torch.tensor(7, dtype=torch.int32)},
          "bias": torch.arange(5, dtype=torch.float32)}
    return jt, tt


def _bits(x):
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().tobytes()
        return x.numpy().tobytes()
    a = np.asarray(x)
    return (a.view(np.int16) if a.dtype.name == "bfloat16" else a).tobytes()


def _sha(d, step=1):
    with open(os.path.join(d, f"step_{step:010d}", "state.sha256")) as f:
        return f.read()


def test_torch_bf16_is_the_jax_words():
    jt, tt = _trees()
    assert tt["w"].dtype == torch.bfloat16
    assert _bits(tt["w"]) == _bits(jt["w"])
    # torch's own float32 -> bfloat16 rounding gives the same words
    assert _bits(torch.from_numpy(_values()).to(torch.bfloat16)) == \
        _bits(jt["w"])


def test_jax_checkpoint_restores_in_the_port_bitwise(tmp_path):
    jt, tt = _trees()
    d = str(tmp_path)
    jck.save(d, 1, jt)
    like = {"w": torch.zeros(4, 6, dtype=torch.bfloat16),
            "opt": {"mu": torch.zeros(4, 6, dtype=torch.bfloat16),
                    "step": torch.zeros((), dtype=torch.int32)},
            "bias": torch.zeros(5)}
    got, step = tck.restore(d, like)
    assert step == 1
    for k in ("w", "bias"):
        assert got[k].dtype == tt[k].dtype and _bits(got[k]) == _bits(tt[k])
    assert got["opt"]["mu"].dtype == torch.bfloat16
    assert _bits(got["opt"]["mu"]) == _bits(jt["opt"]["mu"])
    assert int(got["opt"]["step"]) == 7


def test_port_checkpoint_restores_in_jax_bitwise(tmp_path):
    jt, tt = _trees(1)
    d = str(tmp_path)
    tck.save(d, 3, tt)
    got, step = jck.restore(d, jax.tree.map(jnp.zeros_like, jt))
    assert step == 3
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(jt)):
        assert a.dtype == b.dtype and _bits(a) == _bits(b)


def test_one_tree_writes_one_sha_in_both(jax_writes_zlib, tmp_path):
    jt, tt = _trees(2)
    jck.save(str(tmp_path / "j"), 1, jt)
    tck.save(str(tmp_path / "t"), 1, tt)
    assert _sha(str(tmp_path / "j")) == _sha(str(tmp_path / "t"))
    name = os.path.join("step_0000000001", "state.msgpack.zst")
    with open(tmp_path / "j" / name, "rb") as fj, \
            open(tmp_path / "t" / name, "rb") as ft:
        assert fj.read() == ft.read()


def test_tree_digest_of_bf16_equals_jax():
    jt, tt = _trees(3)
    want = jck.tree_digest(jt)
    assert tree_digest(tt) == want
    # the JAX tree's numpy view (ml_dtypes arrays) digests alike
    assert tree_digest(jax.tree.map(np.asarray, jt)) == want
    # and a changed bfloat16 word changes it
    tt["w"].view(torch.int16)[0, 5] += 1
    assert tree_digest(tt) != want


def test_numpy_bf16_like_restores_as_numpy_bf16(tmp_path):
    jt, _ = _trees(4)
    d = str(tmp_path)
    jck.save(d, 1, jt)
    like = jax.tree.map(np.asarray, jt)
    got, _ = tck.restore(d, like)
    assert got["w"].dtype == like["w"].dtype
    assert _bits(got["w"]) == _bits(jt["w"])


def test_port_handles_bf16_without_ml_dtypes_or_jax(tmp_path):
    code = f"""
import sys, torch
from repro_torch.runtime import checkpoint as ck
from repro_torch.weights import tree_digest
t = {{"w": torch.linspace(-3, 3, 12).to(torch.bfloat16).reshape(3, 4)}}
ck.save({str(tmp_path)!r}, 1, t)
like = {{"w": torch.zeros(3, 4, dtype=torch.bfloat16)}}
got, _ = ck.restore({str(tmp_path)!r}, like)
assert torch.equal(got["w"].view(torch.int16), t["w"].view(torch.int16))
tree_digest(t)
tops = {{m.split(".")[0] for m in sys.modules}}
bad = sorted(tops & {{"ml_dtypes", "jax", "jaxlib", "repro"}})
print("BAD", bad)
"""
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, check=True,
                         capture_output=True, text=True).stdout
    assert "BAD []" in out
