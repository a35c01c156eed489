"""A decompress-only reader of Zstandard frames (RFC 8878), in Python and
numpy.

The JAX package compresses its checkpoints, dataset shards and sweep
cache entries with `zstandard.ZstdCompressor(level=3)` wherever that
package is installed. The port does not use `zstandard` (the machine with
the card lacks it), so it reads those blobs with this decoder:

    from repro_torch.runtime.zstd import decompress
    raw = decompress(comp)

It decodes every frame that a conforming compressor writes without a
dictionary: raw, RLE and compressed blocks; raw, RLE, Huffman-coded and
treeless literals in one or four streams; FSE tables in predefined, RLE,
compressed and repeat modes; repeat offsets; several frames in a row and
skippable frames; and the optional XXH64 content checksum, which it
checks when present. It refuses dictionaries and any malformed input with
an `IOError`, so that `BlobStore.get` quarantines the blob and reads it
as a miss. It aims at being right, not fast: Huffman streams decode by
pointer doubling in numpy, sequences in a Python loop.
"""
from __future__ import annotations

from typing import List, Tuple

import numpy as np

__all__ = ["decompress", "ZSTD_MAGIC", "xxh64"]

ZSTD_MAGIC = b"\x28\xb5\x2f\xfd"
_SKIPPABLE_LO, _SKIPPABLE_HI = 0x184D2A50, 0x184D2A5F
_BLOCK_MAX = 128 * 1024

# ------------------------------------------------- sequence code tables
# (baseline, extra bits) of each literal-length and match-length code
_LL_CODES = [(i, 0) for i in range(16)] + [
    (16, 1), (18, 1), (20, 1), (22, 1), (24, 2), (28, 2), (32, 3), (40, 3),
    (48, 4), (64, 6), (128, 7), (256, 8), (512, 9), (1024, 10), (2048, 11),
    (4096, 12), (8192, 13), (16384, 14), (32768, 15), (65536, 16)]
_ML_CODES = [(i + 3, 0) for i in range(32)] + [
    (35, 1), (37, 1), (39, 1), (41, 1), (43, 2), (47, 2), (51, 3), (59, 3),
    (67, 4), (83, 4), (99, 5), (131, 7), (259, 8), (515, 9), (1027, 10),
    (2051, 11), (4099, 12), (8195, 13), (16387, 14), (32771, 15),
    (65539, 16)]
# predefined distributions (RFC 8878 §3.1.1.3.2.2): (normalized counts,
# accuracy log)
_LL_DEFAULT = ([4, 3, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 2, 1, 1, 1, 2, 2, 2, 2,
                2, 2, 2, 2, 2, 3, 2, 1, 1, 1, 1, 1, -1, -1, -1, -1], 6)
_ML_DEFAULT = ([1, 4, 3, 2, 2, 2, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, 1, 1, -1, -1, -1, -1, -1, -1, -1], 6)
_OF_DEFAULT = ([1, 1, 1, 1, 1, 1, 2, 2, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1, 1,
                1, 1, 1, 1, -1, -1, -1, -1, -1], 5)
# per kind: (max accuracy log, max symbol)
_LL_LIMITS, _OF_LIMITS, _ML_LIMITS = (9, 35), (8, 31), (9, 52)


class _Corrupt(Exception):
    """Internal: malformed input (turned into IOError at the boundary)."""


def _need(cond: bool, what: str):
    if not cond:
        raise _Corrupt(what)


# ------------------------------------------------------------ bit readers
class _ForwardBits:
    """Little-endian bits read forward (FSE table descriptions)."""

    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def read(self, n: int) -> int:
        lo, hi = self.pos >> 3, (self.pos + n + 7) >> 3
        _need(hi <= len(self.data), "table description overruns its data")
        v = int.from_bytes(self.data[lo:hi], "little") >> (self.pos & 7)
        self.pos += n
        return v & ((1 << n) - 1)

    def rewind(self, n: int):
        self.pos -= n

    def bytes_used(self) -> int:
        return (self.pos + 7) >> 3


class _BackwardBits:
    """Bits read backward from the end of a stream (FSE and Huffman
    streams): the last byte's highest set bit marks the start; bits past
    the stream's beginning read as zeros, and `off` goes negative."""

    def __init__(self, data: bytes):
        _need(len(data) > 0 and data[-1] != 0, "bitstream without end mark")
        self.data = data
        self.off = 8 * (len(data) - 1) + data[-1].bit_length() - 1

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        off = self.off - n
        self.off = off
        if off >= 0:
            lo, hi = off >> 3, (off + n + 7) >> 3
            v = int.from_bytes(self.data[lo:hi], "little") >> (off & 7)
            return v & ((1 << n) - 1)
        k = n + off                       # bits that are really there
        if k <= 0:
            return 0
        v = int.from_bytes(self.data[:(k + 7) >> 3], "little") \
            & ((1 << k) - 1)
        return v << (-off)


# -------------------------------------------------------------- FSE tables
def _read_ncount(data: bytes, max_al: int, max_symbol: int
                 ) -> Tuple[List[int], int, int]:
    """An FSE table description: (normalized counts, accuracy log, bytes
    used)."""
    bits = _ForwardBits(data)
    al = bits.read(4) + 5
    _need(al <= max_al, f"FSE accuracy log {al} > {max_al}")
    remaining = 1 << al
    counts: List[int] = []
    while remaining > 0:
        _need(len(counts) <= max_symbol, "FSE table: too many symbols")
        nbits = (remaining + 1).bit_length()
        val = bits.read(nbits)
        lower = (1 << (nbits - 1)) - 1
        threshold = (1 << nbits) - 1 - (remaining + 1)
        if (val & lower) < threshold:
            bits.rewind(1)
            val &= lower
        elif val > lower:
            val -= threshold
        proba = val - 1
        remaining -= -proba if proba < 0 else proba
        counts.append(proba)
        if proba == 0:
            while True:
                repeat = bits.read(2)
                counts.extend([0] * repeat)
                if repeat != 3:
                    break
            _need(len(counts) <= max_symbol + 1, "FSE table: zero run "
                  "past the last symbol")
    _need(remaining == 0, "FSE table: counts do not sum to the table size")
    return counts, al, bits.bytes_used()


def _fse_table(counts: List[int], al: int):
    """Decoding table (symbol, bits, base) per state, in RFC 8878's
    spread order."""
    size = 1 << al
    symbols = [0] * size
    next_desc = [0] * len(counts)
    high = size
    for s, c in enumerate(counts):
        if c == -1:
            high -= 1
            symbols[high] = s
            next_desc[s] = 1
    step = (size >> 1) + (size >> 3) + 3
    mask, pos = size - 1, 0
    for s, c in enumerate(counts):
        if c <= 0:
            continue
        next_desc[s] = c
        for _ in range(c):
            symbols[pos] = s
            pos = (pos + step) & mask
            while pos >= high:
                pos = (pos + step) & mask
    _need(pos == 0, "FSE table: spread does not close")
    nbits, base = [0] * size, [0] * size
    for i in range(size):
        d = next_desc[symbols[i]]
        next_desc[symbols[i]] = d + 1
        nb = al - (d.bit_length() - 1)
        nbits[i] = nb
        base[i] = (d << nb) - size
    return symbols, nbits, base, al


def _rle_table(symbol: int):
    return [symbol], [0], [0], 0


_PREDEFINED = {"ll": _fse_table(*_LL_DEFAULT), "of": _fse_table(*_OF_DEFAULT),
               "ml": _fse_table(*_ML_DEFAULT)}


# ----------------------------------------------------------------- Huffman
def _huffman_weights(data: bytes, pos: int) -> Tuple[List[int], int, int]:
    """The Huffman tree description at data[pos:]: (weights of every
    symbol, the implied last one included; the longest code's length;
    position after it)."""
    _need(pos < len(data), "literals: no Huffman tree description")
    head = data[pos]
    pos += 1
    if head >= 128:                      # 4-bit weights, two per byte
        n = head - 127
        nbytes = (n + 1) // 2
        _need(pos + nbytes <= len(data), "Huffman weights overrun")
        raw = data[pos:pos + nbytes]
        weights = []
        for i in range(n):
            b = raw[i // 2]
            weights.append(b >> 4 if i % 2 == 0 else b & 15)
        pos += nbytes
    else:                                # FSE-coded weights, 2 states
        _need(head > 0 and pos + head <= len(data), "Huffman weights overrun")
        blob = data[pos:pos + head]
        counts, al, used = _read_ncount(blob, 6, 255)
        sym, nb, base, _ = _fse_table(counts, al)
        bits = _BackwardBits(blob[used:])
        s1, s2 = bits.read(al), bits.read(al)
        weights = []
        while True:
            _need(len(weights) < 255, "too many Huffman weights")
            weights.append(sym[s1])
            s1 = base[s1] + bits.read(nb[s1])
            if bits.off < 0:
                weights.append(sym[s2])
                break
            weights.append(sym[s2])
            s2 = base[s2] + bits.read(nb[s2])
            if bits.off < 0:
                weights.append(sym[s1])
                break
        pos += head
    _need(all(w <= 11 for w in weights), "Huffman weight above 11")
    total = sum(1 << (w - 1) for w in weights if w > 0)
    _need(total > 0, "Huffman weights all zero")
    max_bits = total.bit_length()
    left = (1 << max_bits) - total
    _need(left & (left - 1) == 0, "Huffman weights do not complete a tree")
    weights.append(left.bit_length())
    _need(max_bits <= 11, "Huffman code longer than 11 bits")
    return weights, max_bits, pos


def _huffman_table(weights: List[int], max_bits: int):
    """(symbol, bits) per max_bits-wide prefix, as numpy arrays, and
    max_bits: symbols in order of weight then value, each filling
    2**(w-1) entries from the first."""
    size = 1 << max_bits
    sym = np.zeros(size, np.int64)
    nb = np.zeros(size, np.int64)
    order = sorted((w, s) for s, w in enumerate(weights) if w > 0)
    at = 0
    for w, s in order:
        span = 1 << (w - 1)
        sym[at:at + span] = s
        nb[at:at + span] = max_bits + 1 - w
        at += span
    _need(at == size, "Huffman table does not fill")
    return sym, nb, max_bits


def _huffman_stream(data: bytes, count: int, table) -> bytes:
    """Decode `count` symbols from one backward Huffman stream.

    Every bit position p (bits left to read) gives the symbol and code
    length read there, all at once in numpy; the positions actually
    visited, p0 = all bits, p(i+1) = p(i) - length(p(i)), follow by
    pointer doubling. The stream must end exactly at bit 0."""
    sym, nb, max_bits = table
    _need(len(data) > 0 and data[-1] != 0, "Huffman stream without end mark")
    total = 8 * (len(data) - 1) + data[-1].bit_length() - 1
    if count == 0:
        _need(total == 0, "Huffman stream longer than its symbols")
        return b""
    bits = np.unpackbits(np.frombuffer(data, np.uint8),
                         bitorder="little")[:total].astype(np.int64)
    padded = np.concatenate([np.zeros(max_bits, np.int64), bits])
    window = np.zeros(total + 1, np.int64)
    for j in range(max_bits):
        window |= padded[j:j + total + 1] << j
    sink = total + 1                     # a read past the stream's start
    nxt = np.arange(total + 1, dtype=np.int64) - nb[window]
    nxt = np.where(nxt < 0, sink, nxt)
    nxt = np.append(nxt, sink)
    pos = np.empty(count, np.int64)
    pos[0] = total
    filled, jump = 1, nxt
    while filled < count:
        k = min(filled, count - filled)
        pos[filled:filled + k] = jump[pos[:k]]
        filled += k
        if filled < count:
            jump = jump[jump]
    _need(not (pos == sink).any() and nxt[pos[-1]] == 0,
          "Huffman stream does not end where its symbols do")
    return sym[window[pos]].astype(np.uint8).tobytes()


# ----------------------------------------------------------- frame state
class _FrameState:
    def __init__(self):
        self.huffman = None
        self.tables = {"ll": None, "of": None, "ml": None}
        self.rep = [1, 4, 8]


def _literals(block: bytes, st: _FrameState) -> Tuple[bytes, int]:
    """The literals section at the start of a compressed block: (literal
    bytes, bytes the section took)."""
    _need(len(block) >= 1, "empty compressed block")
    b0 = block[0]
    kind, fmt = b0 & 3, (b0 >> 2) & 3
    if kind in (0, 1):                   # raw, RLE
        if fmt in (0, 2):
            size, head = b0 >> 3, 1
        elif fmt == 1:
            _need(len(block) >= 2, "literals header overrun")
            size, head = (b0 >> 4) + (block[1] << 4), 2
        else:
            _need(len(block) >= 3, "literals header overrun")
            size, head = (b0 >> 4) + (block[1] << 4) + (block[2] << 12), 3
        _need(size <= _BLOCK_MAX, "literals larger than a block")
        if kind == 0:
            _need(head + size <= len(block), "raw literals overrun")
            return bytes(block[head:head + size]), head + size
        _need(head < len(block), "RLE literals overrun")
        return bytes([block[head]]) * size, head + 1
    head = {0: 3, 1: 3, 2: 4, 3: 5}[fmt]
    _need(len(block) >= head, "literals header overrun")
    h = int.from_bytes(block[:head], "little")
    width = {3: 10, 4: 14, 5: 18}[head]
    regen = (h >> 4) & ((1 << width) - 1)
    comp = (h >> (4 + width)) & ((1 << width) - 1)
    streams = 1 if fmt == 0 else 4
    _need(regen <= _BLOCK_MAX and head + comp <= len(block),
          "compressed literals overrun")
    body = block[head:head + comp]
    pos = 0
    if kind == 2:
        weights, max_bits, pos = _huffman_weights(body, 0)
        st.huffman = _huffman_table(weights, max_bits)
    else:
        _need(st.huffman is not None, "treeless literals without a table")
    if streams == 1:
        out = _huffman_stream(body[pos:], regen, st.huffman)
    else:
        _need(pos + 6 <= len(body), "literals jump table overrun")
        s1, s2, s3 = (int.from_bytes(body[pos + 2 * i:pos + 2 * i + 2],
                                     "little") for i in range(3))
        pos += 6
        s4 = len(body) - pos - s1 - s2 - s3
        _need(s4 > 0 or (s4 == 0 and regen == 0),
              "literals streams overrun")
        seg = (regen + 3) // 4
        _need(3 * seg <= regen, "literals too short for four streams")
        parts, at = [], pos
        for n, size in ((seg, s1), (seg, s2), (seg, s3),
                        (regen - 3 * seg, s4)):
            parts.append(_huffman_stream(body[at:at + size], n, st.huffman))
            at += size
        out = b"".join(parts)
    return out, head + comp


def _table_for(kind: str, mode: int, block: bytes, pos: int,
               st: _FrameState, limits) -> int:
    """Set `st.tables[kind]` from a symbol compression mode; returns the
    position after its description."""
    if mode == 0:
        st.tables[kind] = _PREDEFINED[kind]
    elif mode == 1:
        _need(pos < len(block), "RLE table overrun")
        _need(block[pos] <= limits[1], "RLE symbol out of range")
        st.tables[kind] = _rle_table(block[pos])
        pos += 1
    elif mode == 2:
        counts, al, used = _read_ncount(block[pos:], *limits)
        st.tables[kind] = _fse_table(counts, al)
        pos += used
    else:
        _need(st.tables[kind] is not None, "repeat mode without a table")
    return pos


def _sequences(block: bytes, pos: int, st: _FrameState):
    """The sequences section at block[pos:]: a list of (literal length,
    match length, offset value) triples."""
    _need(pos < len(block), "no sequences section")
    b0 = block[pos]
    if b0 == 0:
        _need(pos + 1 == len(block), "bytes after an empty sequences section")
        return []
    if b0 < 128:
        nseq, pos = b0, pos + 1
    elif b0 < 255:
        _need(pos + 2 <= len(block), "sequences header overrun")
        nseq, pos = ((b0 - 128) << 8) + block[pos + 1], pos + 2
    else:
        _need(pos + 3 <= len(block), "sequences header overrun")
        nseq = block[pos + 1] + (block[pos + 2] << 8) + 0x7F00
        pos += 3
    _need(pos < len(block), "sequences header overrun")
    modes = block[pos]
    pos += 1
    _need(modes & 3 == 0, "reserved bits of the compression modes set")
    pos = _table_for("ll", modes >> 6, block, pos, st, _LL_LIMITS)
    pos = _table_for("of", (modes >> 4) & 3, block, pos, st, _OF_LIMITS)
    pos = _table_for("ml", (modes >> 2) & 3, block, pos, st, _ML_LIMITS)
    ll_sym, ll_nb, ll_base, ll_al = st.tables["ll"]
    of_sym, of_nb, of_base, of_al = st.tables["of"]
    ml_sym, ml_nb, ml_base, ml_al = st.tables["ml"]
    bits = _BackwardBits(block[pos:])
    read = bits.read
    s_ll, s_of, s_ml = read(ll_al), read(of_al), read(ml_al)
    seqs = []
    for i in range(nseq):
        of_code, ml_code, ll_code = of_sym[s_of], ml_sym[s_ml], ll_sym[s_ll]
        _need(ll_code <= 35 and ml_code <= 52 and of_code <= 31,
              "sequence code out of range")
        offset = (1 << of_code) + read(of_code)
        mb, mn = _ML_CODES[ml_code]
        match = mb + read(mn)
        lb, ln = _LL_CODES[ll_code]
        lit = lb + read(ln)
        seqs.append((lit, match, offset))
        if i + 1 < nseq:
            s_ll = ll_base[s_ll] + read(ll_nb[s_ll])
            s_ml = ml_base[s_ml] + read(ml_nb[s_ml])
            s_of = of_base[s_of] + read(of_nb[s_of])
    _need(bits.off == 0, "sequences bitstream not consumed exactly")
    return seqs


def _execute(out: bytearray, lits: bytes, seqs, st: _FrameState,
             frame_start: int):
    rep = st.rep
    at = 0
    for lit, match, value in seqs:
        _need(at + lit <= len(lits), "sequence reads past the literals")
        out += lits[at:at + lit]
        at += lit
        if value > 3:
            offset = value - 3
            rep[2], rep[1], rep[0] = rep[1], rep[0], offset
        else:
            idx = value - 1 + (lit == 0)
            if idx:
                offset = rep[idx] if idx < 3 else rep[0] - 1
                if idx > 1:
                    rep[2] = rep[1]
                rep[1], rep[0] = rep[0], offset
            else:
                offset = rep[0]
        start = len(out) - offset
        _need(offset > 0 and start >= frame_start,
              "match offset before the frame's start (no dictionary)")
        if offset >= match:
            out += out[start:start + match]
        else:
            pattern = bytes(out[start:])
            out += (pattern * (match // offset + 1))[:match]
    out += lits[at:]


# ------------------------------------------------------------------ XXH64
_P1, _P2, _P3 = 0x9E3779B185EBCA87, 0xC2B2AE3D27D4EB4F, 0x165667B19E3779F9
_P4, _P5 = 0x85EBCA77C2B2AE63, 0x27D4EB2F165667C5
_M64 = (1 << 64) - 1


def _rotl(x: int, r: int) -> int:
    return ((x << r) | (x >> (64 - r))) & _M64


def _round(acc: int, lane: int) -> int:
    return _rotl((acc + lane * _P2) & _M64, 31) * _P1 & _M64


def xxh64(data: bytes, seed: int = 0) -> int:
    """XXH64 of `data` (the hash of zstd's content checksum)."""
    n = len(data)
    i = 0
    if n >= 32:
        v1, v2 = (seed + _P1 + _P2) & _M64, (seed + _P2) & _M64
        v3, v4 = seed, (seed - _P1) & _M64
        lanes = np.frombuffer(data, "<u8", count=(n // 32) * 4).tolist()
        for j in range(0, len(lanes), 4):
            v1 = _round(v1, lanes[j])
            v2 = _round(v2, lanes[j + 1])
            v3 = _round(v3, lanes[j + 2])
            v4 = _round(v4, lanes[j + 3])
        acc = (_rotl(v1, 1) + _rotl(v2, 7) + _rotl(v3, 12)
               + _rotl(v4, 18)) & _M64
        for v in (v1, v2, v3, v4):
            acc = ((acc ^ _round(0, v)) * _P1 + _P4) & _M64
        i = (n // 32) * 32
    else:
        acc = (seed + _P5) & _M64
    acc = (acc + n) & _M64
    while i + 8 <= n:
        lane = int.from_bytes(data[i:i + 8], "little")
        acc = (_rotl(acc ^ _round(0, lane), 27) * _P1 + _P4) & _M64
        i += 8
    if i + 4 <= n:
        lane = int.from_bytes(data[i:i + 4], "little")
        acc = (_rotl(acc ^ (lane * _P1 & _M64), 23) * _P2 + _P3) & _M64
        i += 4
    while i < n:
        acc = _rotl(acc ^ (data[i] * _P5 & _M64), 11) * _P1 & _M64
        i += 1
    acc ^= acc >> 33
    acc = acc * _P2 & _M64
    acc ^= acc >> 29
    acc = acc * _P3 & _M64
    acc ^= acc >> 32
    return acc


# ------------------------------------------------------------------ frames
def _frame(data: bytes, pos: int, out: bytearray) -> int:
    """Decode the zstd frame at data[pos:] (after its magic) into `out`;
    returns the position after it."""
    _need(pos < len(data), "frame header overrun")
    desc = data[pos]
    pos += 1
    fcs_flag, single = desc >> 6, (desc >> 5) & 1
    _need(desc & 8 == 0, "reserved bit of the frame header set")
    checksum, did_flag = (desc >> 2) & 1, desc & 3
    if not single:
        pos += 1                         # window descriptor
    did_size = (0, 1, 2, 4)[did_flag]
    _need(pos + did_size <= len(data), "frame header overrun")
    did = int.from_bytes(data[pos:pos + did_size], "little")
    if did:
        raise IOError(f"zstd frame needs dictionary {did}: dictionaries "
                      "are not supported")
    pos += did_size
    fcs_size = (1 if single else 0, 2, 4, 8)[fcs_flag]
    _need(pos + fcs_size <= len(data), "frame header overrun")
    content = None
    if fcs_size:
        content = int.from_bytes(data[pos:pos + fcs_size], "little")
        if fcs_size == 2:
            content += 256
    pos += fcs_size

    st = _FrameState()
    start = len(out)
    while True:
        _need(pos + 3 <= len(data), "block header overrun")
        h = int.from_bytes(data[pos:pos + 3], "little")
        pos += 3
        last, btype, size = h & 1, (h >> 1) & 3, h >> 3
        if btype == 0:
            _need(pos + size <= len(data), "raw block overrun")
            out += data[pos:pos + size]
            pos += size
        elif btype == 1:
            _need(pos < len(data), "RLE block overrun")
            out += bytes([data[pos]]) * size
            pos += 1
        elif btype == 2:
            _need(size <= _BLOCK_MAX and pos + size <= len(data),
                  "compressed block overrun")
            block = data[pos:pos + size]
            lits, used = _literals(block, st)
            seqs = _sequences(block, used, st)
            _execute(out, lits, seqs, st, start)
            pos += size
        else:
            raise _Corrupt("reserved block type")
        _need(len(out) - start <= (content if content is not None
                                   else len(out)),
              "frame longer than its content size")
        if last:
            break
    if content is not None:
        _need(len(out) - start == content,
              "frame shorter than its content size")
    if checksum:
        _need(pos + 4 <= len(data), "checksum overrun")
        want = int.from_bytes(data[pos:pos + 4], "little")
        got = xxh64(bytes(out[start:])) & 0xFFFFFFFF
        _need(got == want, "content checksum mismatch")
        pos += 4
    return pos


def decompress(data: bytes) -> bytes:
    """Decompress one or more concatenated zstd frames (skippable frames
    are skipped). Raises IOError on anything malformed and on a
    dictionary frame."""
    data = bytes(data)
    out = bytearray()
    pos = 0
    try:
        _need(len(data) >= 4, "no zstd frame")
        while pos < len(data):
            _need(pos + 4 <= len(data), "trailing bytes after the frames")
            magic = int.from_bytes(data[pos:pos + 4], "little")
            pos += 4
            if _SKIPPABLE_LO <= magic <= _SKIPPABLE_HI:
                _need(pos + 4 <= len(data), "skippable frame overrun")
                size = int.from_bytes(data[pos:pos + 4], "little")
                _need(pos + 4 + size <= len(data), "skippable frame overrun")
                pos += 4 + size
                continue
            _need(magic == 0xFD2FB528, f"bad frame magic {magic:#010x}")
            pos = _frame(data, pos, out)
    except _Corrupt as exc:
        raise IOError(f"malformed zstd data: {exc}") from None
    except (IndexError, ValueError, KeyError) as exc:
        raise IOError(f"malformed zstd data: {type(exc).__name__}: "
                      f"{exc}") from None
    return bytes(out)
