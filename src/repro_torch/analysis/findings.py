"""Finding records and the stable fingerprints the baseline keys on.

A copy of `repro.analysis.findings`: a fingerprint hashes (checker,
repo-relative path, the stripped source line, occurrence index among
identical lines), never a line number, so that an unrelated edit to the
same file does not invalidate a baseline entry; the line number is
carried for humans and reports only.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass


@dataclass
class Finding:
    """One analyzer hit, addressable by a line-number-stable fingerprint."""
    checker: str         # checker name, e.g. "host-sync"
    path: str            # repo-relative, forward slashes
    line: int            # 1-based line number (display only, not identity)
    message: str
    source: str = ""     # stripped text of the offending source line
    occurrence: int = 0  # index among findings w/ same (checker, path, source)

    @property
    def fingerprint(self) -> str:
        key = f"{self.checker}|{self.path}|{self.source}|{self.occurrence}"
        return hashlib.sha256(key.encode()).hexdigest()[:16]

    def render(self) -> str:
        return (f"{self.path}:{self.line}: [{self.checker}] {self.message}\n"
                f"    {self.source}\n    fingerprint: {self.fingerprint}")

    def to_json(self) -> dict:
        return {"fingerprint": self.fingerprint, "checker": self.checker,
                "path": self.path, "line": self.line,
                "message": self.message, "source": self.source}


def assign_occurrences(findings: list) -> list:
    """Number findings that share (checker, path, source-line text) so two
    identical offending lines in one file get distinct fingerprints."""
    seen: dict = {}
    for f in sorted(findings, key=lambda f: (f.path, f.line, f.checker)):
        k = (f.checker, f.path, f.source)
        f.occurrence = seen.get(k, 0)
        seen[k] = f.occurrence + 1
    return findings
