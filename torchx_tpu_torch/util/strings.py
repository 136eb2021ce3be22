"""Small string helpers (reference analog: torchx/util/strings.py)."""

from __future__ import annotations

import re


def normalize_str(s: str, max_len: int = 63) -> str:
    """Lowercase alnum+dash, trimmed — safe for DNS labels / job names."""
    s = re.sub(r"[^a-z0-9\-]", "-", s.lower())
    s = re.sub(r"-+", "-", s).strip("-")
    return s[:max_len].rstrip("-")


def truncate_middle(s: str, max_len: int) -> str:
    """Keep head and tail when shortening (ids carry entropy at both ends)."""
    if len(s) <= max_len:
        return s
    if max_len <= 3:
        return s[:max_len]
    head = (max_len - 3 + 1) // 2
    tail = max_len - 3 - head
    return s[:head] + "..." + (s[-tail:] if tail else "")
