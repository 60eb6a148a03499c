"""Version comparison for the self-update surfaces (CLI `self-update`,
`/api/desktop/update-status`). PEP-440-ish without a dependency: numeric
segments compare numerically, a pre-release suffix ("rc1", "a2") sorts
below the bare release of the same number, missing segments read as
".0" (reference update.rs compares release tags the same way).

The port's copy of ``panoptikon_tpu/utils/version.py``, held to it unit for unit by
``tests/test_torch_host_copies.py``.
"""

from __future__ import annotations

import re


def _parts(v: str) -> list[tuple]:
    out: list[tuple] = []
    for seg in v.split("."):
        m = re.match(r"(\d+)(.*)", seg)
        if m:
            suffix = m.group(2)
            out.append((int(m.group(1)), 0 if suffix else 1, suffix))
        else:
            out.append((-1, 0, seg))
    return out


def newer_than(a: str, b: str) -> bool:
    """True when version ``a`` is strictly newer than ``b``."""
    pa, pb = _parts(a), _parts(b)
    pad = (0, 1, "")
    n = max(len(pa), len(pb))
    return pa + [pad] * (n - len(pa)) > pb + [pad] * (n - len(pb))


def fetch_manifest(url: str, timeout: float = 30.0) -> dict:
    """Load a JSON release manifest ({"version", "requirement"}) from any
    urllib-openable URL (file:// included — no egress assumption)."""
    import json
    import urllib.request

    with urllib.request.urlopen(url, timeout=timeout) as resp:
        return json.loads(resp.read().decode())
