"""ANSI color helpers for CLI output (reference analog: torchx/util/colors.py)."""

from __future__ import annotations

import sys

RESET = "\x1b[0m"
_CODES = {
    "red": 31,
    "green": 32,
    "yellow": 33,
    "blue": 34,
    "magenta": 35,
    "cyan": 36,
    "gray": 90,
}


def supports_color(stream=sys.stdout) -> bool:  # noqa: ANN001
    return hasattr(stream, "isatty") and stream.isatty()


def colored(text: str, color: str, enabled: bool = True) -> str:
    if not enabled or color not in _CODES:
        return text
    return f"\x1b[{_CODES[color]}m{text}{RESET}"


def state_color(state_name: str) -> str:
    """Conventional color for an AppState name."""
    return {
        "RUNNING": "green",
        "SUCCEEDED": "green",
        "FAILED": "red",
        "CANCELLED": "yellow",
        "PREEMPTED": "yellow",
        "PENDING": "cyan",
        "SUBMITTED": "cyan",
    }.get(state_name, "gray")
