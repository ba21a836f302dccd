"""Seeds of a run's separate draws, each derived from ``--seed``."""

from __future__ import annotations

import hashlib


def derive(seed: int, purpose: str) -> int:
    """A 63-bit seed for ``purpose`` (the env's sampler, the root noise, the
    weights, the host's choices), the same for the same ``--seed``."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1
