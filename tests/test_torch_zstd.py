"""The port's zstd decoder (`repro_torch/runtime/zstd.py`) against the
`zstandard` package, bitwise:

- the JAX package's checkpoints (at test width and at `M4Config()`
  width), its `DatasetStore` shards and `ResultCache` entries, which it
  writes with `zstandard.ZstdCompressor(level=3)` where that package is
  installed;
- corpora of several kinds at levels 1, 3 and 19 (and a negative, fast
  level), with and without the content checksum, which covers raw, RLE
  and compressed blocks, raw, RLE, Huffman and treeless literals in one
  and four streams, and FSE tables in every mode;
- empty input, RLE and raw blocks, frames without a content size, two
  concatenated frames and skippable frames; XXH64 on its own.

Anything malformed, a flipped byte, a bad checksum or a dictionary frame
raises IOError, which the blob store turns into a quarantined miss.
"""
import hashlib
import os

import numpy as np
import pytest

zstandard = pytest.importorskip("zstandard")
# one torch thread: the suite's xdist workers share the host's cores
pytest.importorskip("torch").set_num_threads(1)

from repro_torch.runtime import blobstore  # noqa: E402
from repro_torch.runtime.zstd import decompress, xxh64  # noqa: E402

TINY = dict(hidden=16, gnn_dim=12, mlp_hidden=8, gnn_layers=2,
            snap_flows=8, snap_links=24)


def _corpora():
    rng = np.random.default_rng(0)
    floats = rng.normal(size=60000).astype(np.float32).tobytes()
    return {
        "empty": b"",
        "byte": b"a",
        "text": b"the quick brown fox jumps over the lazy dog " * 300,
        "floats": floats,
        "zeros": bytes(300000),
        "ints": np.arange(60000, dtype=np.int32).tobytes(),
        "random": bytes(rng.integers(0, 256, 150000, dtype=np.uint8)),
        "skewed": bytes(rng.geometric(0.3, 200000).clip(0, 255)
                        .astype(np.uint8)),
        "mixed": b"".join(floats[i * 4000:(i + 1) * 4000] + bytes(3000)
                          + b"abc" * 500 for i in range(20)),
        "alphabet": bytes(rng.choice(np.frombuffer(b"ACGT", np.uint8),
                                     100000)),
    }


CORPORA = _corpora()


@pytest.mark.parametrize("level", [1, 3, 19, -5])
@pytest.mark.parametrize("checksum", [False, True])
def test_corpora_decode_bitwise(level, checksum):
    c = zstandard.ZstdCompressor(level=level, write_checksum=checksum)
    for name, raw in CORPORA.items():
        comp = c.compress(raw)
        assert decompress(comp) == zstandard.decompress(comp) == raw, name


def test_frames_without_content_size_and_in_a_row():
    raw = CORPORA["mixed"]
    c = zstandard.ZstdCompressor(level=3)
    # a streamed frame has no content size, and a flush ends a block early
    chunker = c.chunker(chunk_size=32768)
    comp = b"".join(list(chunker.compress(raw[:70000])) + list(
        chunker.flush()) + list(chunker.compress(raw[70000:]))
        + list(chunker.finish()))
    assert decompress(comp) == raw
    two = c.compress(b"hello") + c.compress(CORPORA["text"])
    assert decompress(two) == b"hello" + CORPORA["text"]
    skip = (0x184D2A53).to_bytes(4, "little") + (5).to_bytes(4, "little") \
        + b"xxxxx"
    assert decompress(skip + two + skip) == b"hello" + CORPORA["text"]


def _frame(blocks, content_size=None):
    """A hand-made frame of (type, payload, regenerated size) blocks."""
    if content_size is None:
        head = bytes([0x00, 0x58])               # no single segment, 1 MiB
    else:
        head = bytes([0x20, content_size])       # single segment, 1 byte
    out = b"\x28\xb5\x2f\xfd" + head
    for i, (kind, payload, size) in enumerate(blocks):
        last = int(i == len(blocks) - 1)
        out += (last | (kind << 1) | (size << 3)).to_bytes(3, "little")
        out += payload
    return out


def test_raw_and_rle_blocks():
    frame = _frame([(0, b"hello ", 6), (1, b"z", 9), (0, b"!", 1)])
    assert decompress(frame) == zstandard.decompress(
        frame, max_output_size=1 << 10) == b"hello " + b"z" * 9 + b"!"
    frame = _frame([(1, b"\x07", 200)], content_size=200)
    assert decompress(frame) == zstandard.decompress(frame) == b"\x07" * 200
    empty = _frame([(0, b"", 0)], content_size=0)
    assert decompress(empty) == zstandard.decompress(empty) == b""


def test_malformed_input_raises_ioerror():
    comp = bytearray(zstandard.ZstdCompressor(
        level=3, write_checksum=True).compress(CORPORA["mixed"]))
    for bad in (b"", b"\x28\xb5\x2f", b"not zstd at all",
                bytes(comp[:len(comp) // 2]), bytes(comp) + b"\x01"):
        with pytest.raises(IOError):
            decompress(bad)
    # a flipped byte anywhere in the body: wrong content, caught by the
    # checksum if by nothing earlier
    rng = np.random.default_rng(1)
    for pos in rng.integers(6, len(comp), 20):
        flipped = bytearray(comp)
        flipped[pos] ^= 0x40
        with pytest.raises(IOError):
            decompress(bytes(flipped))
    # a frame that names a dictionary is refused by name
    frame = b"\x28\xb5\x2f\xfd" + bytes([0x21, 0x07, 0x01]) \
        + (1 | (0 << 1) | (1 << 3)).to_bytes(3, "little") + b"a"
    with pytest.raises(IOError, match="dictionar"):
        decompress(frame)


def test_xxh64_known_values():
    # the XXH64 reference vectors (seed 0)
    assert xxh64(b"") == 0xEF46DB3751D8E999
    assert xxh64(b"a") == 0xD24EC4F1A98C6E5B
    assert xxh64(b"abc") == 0x44BC2CF5AD770999
    # every tail length around the 32-byte stripe is checked by the frame
    # checksum, which zstandard computes independently
    c = zstandard.ZstdCompressor(level=1, write_checksum=True)
    for n in list(range(0, 70)) + [1000, 4097]:
        raw = bytes(range(256)) * (n // 256 + 1)
        assert decompress(c.compress(raw[:n])) == raw[:n]


# ------------------------------------------- the JAX package's own blobs
jax = pytest.importorskip("jax")

from repro.core.model import M4Config as JaxM4Config  # noqa: E402
from repro.runtime import checkpoint as jck  # noqa: E402
from repro.train import init_state as jax_init_state  # noqa: E402


def _checkpoint_body(tmp_path, cfg):
    d = str(tmp_path / "ck")
    jck.save(d, 1, jax_init_state(cfg, seed=3).tree())
    with open(os.path.join(d, "step_0000000001", "state.msgpack.zst"),
              "rb") as f:
        return f.read()


@pytest.mark.parametrize("width", ["test", "M4Config"])
def test_jax_checkpoint_decodes_bitwise(width, tmp_path):
    cfg = JaxM4Config(**TINY) if width == "test" else JaxM4Config()
    comp = _checkpoint_body(tmp_path, cfg)
    assert comp[:4] == b"\x28\xb5\x2f\xfd"
    assert decompress(comp) == zstandard.decompress(comp)


def test_jax_store_entries_decode_bitwise(tmp_path):
    from repro.data.traffic import sample_scenario
    from repro.net.packetsim import PacketSim
    from repro.core.events import build_event_batch
    from repro.scenarios import ResultCache as JaxCache
    from repro.sim import SimRequest, get_backend
    from repro.train import DatasetStore as JaxStore
    from repro_torch.scenarios import ResultCache
    from repro_torch.train import DatasetStore
    sc = sample_scenario(0, num_flows=30)
    trace = PacketSim(sc.topo, sc.config).run(sc.generate())
    batch = build_event_batch(trace, JaxM4Config(**TINY), max_events=48)
    res = get_backend("flowsim").run(SimRequest.from_scenario(sc))
    key = "ab" * 32
    for jstore, tstore, obj in (
            (JaxStore(str(tmp_path / "d")), DatasetStore(str(tmp_path / "d")),
             batch),
            (JaxCache(str(tmp_path / "r")), ResultCache(str(tmp_path / "r")),
             res)):
        path = jstore.put(key, obj)
        with open(path, "rb") as f:
            body = f.read()[4 + 32:]
        assert body[:4] == b"\x28\xb5\x2f\xfd"
        assert decompress(body) == zstandard.decompress(body)
    got = DatasetStore(str(tmp_path / "d")).get(key)
    for k, v in batch.to_arrays().items():
        assert got.to_arrays()[k].tobytes() == np.asarray(v).tobytes(), k
    hit = ResultCache(str(tmp_path / "r")).get(key)
    assert hit.fcts.tobytes() == np.asarray(res.fcts, np.float64).tobytes()


def test_flipped_byte_in_a_jax_blob_is_a_quarantined_miss(tmp_path):
    from repro.scenarios import ResultCache as JaxCache
    from repro.sim import SimResult
    from repro_torch.scenarios import ResultCache
    res = SimResult(fcts=np.linspace(1e-5, 1e-3, 500),
                    slowdowns=np.linspace(1, 9, 500), wall_time=0.5,
                    backend="packet")
    # a flipped byte of the stored file: the envelope's hash catches it
    path = JaxCache(str(tmp_path)).put("cd" * 32, res)
    assert ResultCache(str(tmp_path)).get("cd" * 32) is not None
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0x10
    open(path, "wb").write(bytes(data))
    assert ResultCache(str(tmp_path)).get("cd" * 32) is None
    assert os.path.exists(path + ".corrupt") and not os.path.exists(path)
    # a truncated zstd body under a valid envelope: the decoder objects
    path = JaxCache(str(tmp_path)).put("ef" * 32, res)
    body = open(path, "rb").read()[36:-7]
    with pytest.raises(IOError):
        decompress(body)
    with open(path, "wb") as f:
        f.write(blobstore._ENVELOPE_MAGIC + hashlib.sha256(body).digest()
                + body)
    assert ResultCache(str(tmp_path)).get("ef" * 32) is None
    assert os.path.exists(path + ".corrupt") and not os.path.exists(path)
