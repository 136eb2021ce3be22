"""Unique app-id generation (reference analog: torchx/schedulers/ids.py)."""

from __future__ import annotations

import random
import string

_ALPHABET = string.ascii_lowercase + string.digits  # base-36


def random_id(length: int = 13) -> str:
    return "".join(random.choices(_ALPHABET, k=length))


def make_unique(name: str) -> str:
    """``trainer`` -> ``trainer-d8se6kyiptu2a`` (collision-safe suffix)."""
    return f"{cleanup(name)}-{random_id()}"


def cleanup(name: str) -> str:
    """Normalize to DNS-1123-ish: lowercase alphanumerics and dashes."""
    from torchx_tpu_torch.util.strings import normalize_str

    return normalize_str(name, max_len=10_000) or "app"


def sanitize_name(name: str, max_len: int = 53) -> str:
    """DNS-1123-ish identifier shortened to ``max_len``: truncation appends
    a suffix derived from a *hash* of the full name so repeated calls
    agree — any derived strings (selectors, DNS names, labels) resolve to
    the same value. Shared by the gke (pod-name budget) and gcp_batch
    (63-char job-id/label cap) schedulers."""
    import hashlib

    name = cleanup(name)
    if len(name) > max_len:
        digest = hashlib.sha1(name.encode()).hexdigest()[:5]
        name = name[: max_len - 6].rstrip("-") + "-" + digest
    return name
