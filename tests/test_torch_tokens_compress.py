"""The port's token pipeline (`repro_torch.data.tokens`) and gradient
compression (`repro_torch.optim.compress`) against the JAX package's:

- `TokenPipeline.batch` bitwise over seeds, steps and host shards;
- `topk_compress` / `topk_decompress` / `ef_compress_update` bitwise on
  arrays with ties in magnitude (`lax.top_k` keeps the lower index), in
  float32 and bfloat16, at fractions that cut through a tie;
- the error-feedback signal test of tests/test_runtime.py mirrored: the
  same gradient sent 50 times, the transmitted mass points along it.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # xdist workers share the host's cores
jax = pytest.importorskip("jax")
jnp = jax.numpy

from repro.data.tokens import TokenPipeline as JaxPipeline  # noqa: E402
from repro.optim import compress as jc  # noqa: E402
from repro_torch.data.tokens import TokenPipeline  # noqa: E402
from repro_torch.optim import (ef_compress_update, topk_compress,  # noqa: E402
                               topk_decompress)
from repro_torch.weights import leaf_numpy  # noqa: E402


@pytest.mark.parametrize("seed,vocab,seq,batch,hosts", [
    (0, 256, 16, 8, 1), (3, 100, 16, 8, 2), (7, 32000, 33, 12, 3),
    (123, 50, 1, 4, 4)])
def test_token_pipeline_bitwise(seed, vocab, seq, batch, hosts):
    for host in range(hosts):
        kw = dict(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed,
                  host_id=host, num_hosts=hosts)
        ours, theirs = TokenPipeline(**kw), JaxPipeline(**kw)
        assert ours.host_batch == theirs.host_batch
        for step in (0, 1, 5, 1000):
            a, b = ours.batch(step), theirs.batch(step)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype == np.int32
                np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _tied(rng, shape):
    """Magnitudes drawn from a few levels, with both signs: many ties."""
    levels = np.array([0.0, 0.5, 1.0, 2.0, 3.0], np.float32)
    sign = np.where(rng.random(shape) < 0.5, -1.0, 1.0).astype(np.float32)
    return levels[rng.integers(0, len(levels), shape)] * sign


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,frac", [((64,), 0.1), ((8, 16), 0.05),
                                        ((4, 5, 6), 0.3), ((3,), 0.01),
                                        ((2, 50), 1.0)])
def test_compression_bitwise_with_ties(shape, frac, dtype):
    rng = np.random.default_rng(len(shape) * 100 + int(frac * 100))
    g, e = _tied(rng, shape), _tied(rng, shape) * 0.25
    jdt = jnp.float32 if dtype == "float32" else jnp.bfloat16
    tdt = torch.float32 if dtype == "float32" else torch.bfloat16
    jg, je = jnp.asarray(g, jdt), jnp.asarray(e, jdt)
    tg, te = torch.from_numpy(g).to(tdt), torch.from_numpy(e).to(tdt)

    jv, ji, jshape = jc.topk_compress(jg, frac)
    tv, ti, tshape = topk_compress(tg, frac)
    assert tuple(tshape) == tuple(jshape)
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_array_equal(leaf_numpy(tv),
                                  np.asarray(jv, np.float32))
    np.testing.assert_array_equal(
        leaf_numpy(topk_decompress(tv, ti, tshape)),
        np.asarray(jc.topk_decompress(jv, ji, jshape), np.float32))

    js, jerr = jc.ef_compress_update(jg, je, frac)
    ts, terr = ef_compress_update(tg, te, frac)
    assert ts.dtype == terr.dtype == tdt
    np.testing.assert_array_equal(leaf_numpy(ts), np.asarray(js, np.float32))
    np.testing.assert_array_equal(leaf_numpy(terr),
                                  np.asarray(jerr, np.float32))


def test_gradient_compression_preserves_signal():
    """tests/test_runtime.py::test_gradient_compression_preserves_signal
    on the port, and its accumulated mass against JAX's."""
    rng = np.random.default_rng(0)
    g = rng.normal(size=512).astype(np.float32)
    tg, jg = torch.from_numpy(g), jnp.asarray(g)
    err, acc = torch.zeros_like(tg), torch.zeros_like(tg)
    jerr, jacc = jnp.zeros_like(jg), jnp.zeros_like(jg)
    for _ in range(50):  # same gradient repeatedly: EF must converge to it
        s, err = ef_compress_update(tg, err, frac=0.05)
        acc = acc + s
        js, jerr = jc.ef_compress_update(jg, jerr, frac=0.05)
        jacc = jacc + js
    cos = float(torch.dot(acc, tg) / (acc.norm() * tg.norm()))
    assert cos > 0.97
    np.testing.assert_allclose(acc.numpy(), np.asarray(jacc), rtol=1e-6,
                               atol=1e-6)
