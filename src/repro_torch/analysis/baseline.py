"""The committed suppression baseline (`analysis/baseline.json`, beside
this module).

A copy of `repro.analysis.baseline`. An entry acknowledges one finding as
deliberate and must carry a one-line justification: `--check` rejects an
empty one or one that starts with "TODO", so the file is the reviewed
list of every exception the port grants itself. Entries key on
`Finding.fingerprint`; deleting the offending line makes its entry
*stale*, which `--check` reports without failing, so that it is removed
in the change that fixed the code.
"""
from __future__ import annotations

import json
import os
from typing import Dict, List, Sequence, Tuple

from .findings import Finding

VERSION = 1


def load_baseline(path: str) -> Dict[str, dict]:
    """fingerprint -> entry dict; missing file = empty baseline."""
    if not path or not os.path.exists(path):
        return {}
    with open(path) as f:
        data = json.load(f)
    if data.get("version") != VERSION:
        raise ValueError(f"baseline {path}: unsupported version "
                         f"{data.get('version')!r} (want {VERSION})")
    return {e["fingerprint"]: e for e in data.get("entries", [])}


def save_baseline(path: str, findings: Sequence[Finding],
                  justifications: Dict[str, str] = None,
                  previous: Dict[str, dict] = None) -> None:
    """Write every finding as an entry, keeping justifications from
    `previous` where fingerprints match (new entries get a TODO marker
    that `--check` refuses, so that a reason must be written)."""
    justifications = justifications or {}
    previous = previous or {}
    entries = []
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.checker)):
        just = justifications.get(
            f.fingerprint,
            previous.get(f.fingerprint, {}).get("justification",
                                                "TODO: justify or fix"))
        entries.append({"fingerprint": f.fingerprint, "checker": f.checker,
                        "path": f.path, "line": f.line, "source": f.source,
                        "justification": just})
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump({"version": VERSION, "entries": entries}, fh, indent=1)
        fh.write("\n")
    os.replace(tmp, path)


def partition(findings: Sequence[Finding], baseline: Dict[str, dict],
              ) -> Tuple[List[Finding], List[Finding], List[dict]]:
    """(new, baselined, stale-entries)."""
    fps = {f.fingerprint for f in findings}
    new = [f for f in findings if f.fingerprint not in baseline]
    known = [f for f in findings if f.fingerprint in baseline]
    stale = [e for fp, e in baseline.items() if fp not in fps]
    return new, known, stale


def unjustified(baseline: Dict[str, dict]) -> List[dict]:
    return [e for e in baseline.values()
            if not e.get("justification", "").strip()
            or e["justification"].startswith("TODO")]
