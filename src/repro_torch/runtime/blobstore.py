"""Content-addressed blob store: the machinery behind the sweep result
cache (`repro_torch.scenarios.ResultCache`), the training dataset store
(`repro_torch.train.DatasetStore`), the compression of the checkpoints
(`repro_torch.runtime.checkpoint`), and, with `LeaseDir`, the fleet's
coordination spine (`repro_torch.fleet`).

A copy of what the port needs of `repro.runtime.blobstore`: the layout
`<root>/<key[:2]>/<key>.msgpack.z`, the integrity envelope (a 4-byte magic
plus the sha256 of the compressed body, verified on every read), atomic
writes (unique tempfile + rename) and quarantine of a corrupt entry
(renamed to `<path>.corrupt`, read as a miss). Payloads go through the
port's own msgpack codec (`runtime.codec`), which writes the same bytes as
the `msgpack` package, and compress with zlib, as the JAX package does
where `zstandard` is not installed. A zstd blob, which the JAX package
writes where `zstandard` is installed, reads through the port's own
decoder (`runtime.zstd`), never the `zstandard` package. Subclasses
define only the payload codec (`_encode`/`_decode`).

`LeaseDir` is the JAX package's lease files, the same files and bodies:
an O_CREAT|O_EXCL claim carrying the owner id, liveness by heartbeat
mtime. Leases keep two workers from computing one chunk; they are not
what makes a result right (blob writes are content-addressed and
atomic, so a broken lease costs duplicate work writing the same bytes).
"""
from __future__ import annotations

import hashlib
import json
import logging
import os
import tempfile
import time
import zlib
from typing import List, Optional

from .codec import packb, unpackb
from .zstd import ZSTD_MAGIC
from .zstd import decompress as zstd_decompress

logger = logging.getLogger("repro_torch.blobstore")

# integrity envelope: magic + sha256(compressed body) + compressed body.
# A file without the magic is corrupt: quarantined, read as a miss.
_ENVELOPE_MAGIC = b"RBS1"
_DIGEST_LEN = 32


def _compress(raw: bytes) -> bytes:
    """zlib at level 6: what the JAX package writes without `zstandard`."""
    return zlib.compress(raw, 6)


def _decompress(comp: bytes) -> bytes:
    """zstd (sniffed by its magic) or zlib; malformed input raises."""
    if comp[:4] == ZSTD_MAGIC:
        return zstd_decompress(comp)
    return zlib.decompress(comp)


class BlobStore:
    """Directory of compressed msgpack blobs addressed by content key."""

    def __init__(self, root: str):
        self.root = root

    # ------------------------------------------------------- payload codec
    def _encode(self, obj) -> dict:
        """Object -> msgpack-able payload dict."""
        raise NotImplementedError

    def _decode(self, payload: dict):
        """Inverse of `_encode`."""
        raise NotImplementedError

    # ----------------------------------------------------------- mechanics
    def _path(self, key: str) -> str:
        return os.path.join(self.root, key[:2], key + ".msgpack.z")

    def __contains__(self, key: str) -> bool:
        return os.path.exists(self._path(key))

    def _quarantine(self, path: str, why: str):
        """Rename a corrupt entry aside (never delete — forensics) so the
        next build replaces it and other readers see a clean miss."""
        try:
            os.replace(path, path + ".corrupt")
            logger.warning("quarantined corrupt blob %s -> %s.corrupt (%s)",
                           path, path, why)
        except OSError:
            pass    # a concurrent process quarantined or replaced it first

    def get(self, key: str) -> Optional[object]:
        """The stored object, or None on miss/corruption.

        Every read verifies the envelope's content hash, so a truncated
        or bit-flipped entry can never decode into garbage — it is
        quarantined (renamed to `<path>.corrupt` with a warning) and
        treated as a cache miss for the caller to rebuild."""
        path = self._path(key)
        try:
            with open(path, "rb") as f:
                data = f.read()
        except OSError:
            return None
        try:
            if data[:4] != _ENVELOPE_MAGIC:
                raise IOError("no RBS1 envelope")
            digest = data[4:4 + _DIGEST_LEN]
            comp = data[4 + _DIGEST_LEN:]
            if hashlib.sha256(comp).digest() != digest:
                raise IOError("content hash mismatch")
            payload = unpackb(_decompress(comp))
            return self._decode(payload)
        except Exception as exc:
            self._quarantine(path, f"{type(exc).__name__}: {exc}")
            return None

    def put(self, key: str, obj) -> str:
        """Atomically persist one object (unique tmp, rename into place)."""
        path = self._path(key)
        os.makedirs(os.path.dirname(path), exist_ok=True)
        raw = packb(self._encode(obj))
        comp = _compress(raw)
        body = _ENVELOPE_MAGIC + hashlib.sha256(comp).digest() + comp
        fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path), suffix=".tmp")
        try:
            with os.fdopen(fd, "wb") as f:
                f.write(body)
            os.replace(tmp, path)
        except BaseException:
            try:
                os.remove(tmp)
            except OSError:
                pass
            raise
        return path


class LeaseDir:
    """Atomic lease files for claiming work (`repro_torch.fleet`).

    A lease is one file `<root>/<task_id>.lease` created with
    O_CREAT|O_EXCL (the filesystem picks exactly one winner per task),
    whose JSON body names the owner (worker id, pid, claim time) and
    whose mtime is the owner's heartbeat: a holder `heartbeat()`s while
    it runs the chunk, and a supervisor treats `age() > timeout` as a
    dead or wedged owner and breaks the lease. The body is written
    through the O_EXCL descriptor, and losers never touch the file.
    """

    def __init__(self, root: str):
        self.root = root

    def _path(self, task_id: str) -> str:
        return os.path.join(self.root, task_id + ".lease")

    def claim(self, task_id: str, owner: str,
              meta: Optional[dict] = None) -> bool:
        """Try to claim `task_id` for `owner`; True iff we won the file.
        `meta` (JSON-able) is merged into the body: fleet workers carry
        their trace and span ids there."""
        os.makedirs(self.root, exist_ok=True)
        try:
            fd = os.open(self._path(task_id),
                         os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        body = {"owner": owner, "pid": os.getpid(), "t_claim": time.time()}
        if meta:
            body.update(meta)
        with os.fdopen(fd, "w") as f:
            json.dump(body, f)
        return True

    def heartbeat(self, task_id: str):
        """Refresh the lease mtime (no-op if the lease was broken)."""
        try:
            os.utime(self._path(task_id))
        except OSError:
            pass

    def release(self, task_id: str):
        try:
            os.remove(self._path(task_id))
        except OSError:
            pass

    def owner(self, task_id: str) -> Optional[dict]:
        """The claim body ({owner, pid, t_claim, ...}), or None if
        unclaimed (or claimed so recently the body isn't visible yet)."""
        try:
            with open(self._path(task_id)) as f:
                return json.load(f)
        except (OSError, ValueError):
            return None

    def age(self, task_id: str) -> Optional[float]:
        """Seconds since the last heartbeat, or None if unclaimed."""
        try:
            return time.time() - os.path.getmtime(self._path(task_id))
        except OSError:
            return None

    def held(self, task_id: str) -> bool:
        return os.path.exists(self._path(task_id))

    def active(self) -> List[str]:
        """Task ids of every lease currently on disk."""
        try:
            names = os.listdir(self.root)
        except OSError:
            return []
        return [n[:-len(".lease")] for n in names if n.endswith(".lease")]
