"""Overlays: deep-merge patches applied to raw scheduler request objects.

Reference analog: torchx/specs/overlays.py (653 LoC). An overlay is a dict
stored in ``role.metadata["overlays"][<scheduler>]`` that the scheduler
deep-merges onto the materialized request at dryrun time (e.g. patching an
arbitrary field of the generated JobSet/Pod spec that the launcher doesn't
model first-class).

Merge semantics per key:

* plain key — recursive strategic merge (dicts merge, scalars replace),
* ``PUT(key)`` — replace the value wholesale (no recursion),
* ``JOIN(key[, merge_key])`` — list merge: items are matched by
  ``merge_key`` (default ``"name"``) and merged; unmatched items append,
* ``DEL(key)`` — remove the key from the target.

Operator keys are encoded as ``"<op>!<key>"`` strings so overlays stay
plain JSON (serializable through .tpxconfig and the CLI).
"""

from __future__ import annotations

import copy
from typing import Any, Mapping, Optional

from torchx_tpu_torch.specs.api import Role

_OP_SEP = "!"
_OPS = ("put", "join", "del")

OVERLAY_METADATA_KEY = "overlays"


def PUT(key: str) -> str:
    """Replace the value at ``key`` wholesale instead of merging."""
    return f"put{_OP_SEP}{key}"


def JOIN(key: str, merge_key: str = "name") -> str:
    """Merge list items by ``merge_key`` instead of replacing the list."""
    return f"join{_OP_SEP}{key}{_OP_SEP}{merge_key}"


def DEL(key: str) -> str:
    """Delete ``key`` from the target."""
    return f"del{_OP_SEP}{key}"


def _parse_key(key: str) -> tuple[str, str, str]:
    """-> (op, plain_key, merge_key)"""
    parts = key.split(_OP_SEP)
    if len(parts) >= 2 and parts[0] in _OPS:
        op = parts[0]
        plain = parts[1]
        merge_key = parts[2] if len(parts) > 2 else "name"
        return op, plain, merge_key
    return "merge", key, "name"


def validate_overlay(overlay: Any, path: str = "$") -> list[str]:
    """Static validation: operator syntax + JSON-representable values."""
    errors: list[str] = []
    if not isinstance(overlay, dict):
        return [f"{path}: overlay must be a dict, got {type(overlay).__name__}"]
    for key, value in overlay.items():
        if not isinstance(key, str):
            errors.append(f"{path}: non-string key {key!r}")
            continue
        op, plain, _ = _parse_key(key)
        if not plain:
            errors.append(f"{path}: operator key {key!r} missing target key")
        if op == "del" and value not in (None, {}, ""):
            errors.append(f"{path}.{plain}: DEL value must be empty/None")
        if isinstance(value, dict):
            errors.extend(validate_overlay(value, f"{path}.{plain}"))
    return errors


def apply_overlay(target: Any, overlay: Mapping[str, Any]) -> Any:
    """Return a new object: overlay strategically merged onto target."""
    target = copy.deepcopy(target)
    return _merge(target, overlay)


def _merge(target: Any, overlay: Mapping[str, Any]) -> Any:
    if not isinstance(target, dict):
        # overlay at a non-dict node replaces it
        return copy.deepcopy({k: v for k, v in overlay.items()})
    for key, value in overlay.items():
        op, plain, merge_key = _parse_key(key)
        if op == "del":
            target.pop(plain, None)
        elif op == "put":
            target[plain] = copy.deepcopy(value)
        elif op == "join":
            target[plain] = _join_lists(target.get(plain), value, merge_key)
        else:  # strategic merge
            existing = target.get(plain)
            if isinstance(existing, dict) and isinstance(value, dict):
                target[plain] = _merge(existing, value)
            else:
                target[plain] = copy.deepcopy(value)
    return target


def _join_lists(existing: Any, patch: Any, merge_key: str) -> list:
    if not isinstance(patch, list):
        raise ValueError(f"JOIN value must be a list, got {type(patch).__name__}")
    out: list = list(copy.deepcopy(existing)) if isinstance(existing, list) else []
    for item in patch:
        if isinstance(item, dict) and merge_key in item:
            match = next(
                (
                    i
                    for i, cur in enumerate(out)
                    if isinstance(cur, dict) and cur.get(merge_key) == item[merge_key]
                ),
                None,
            )
            if match is not None:
                out[match] = _merge(out[match], item)
                continue
        out.append(copy.deepcopy(item))
    return out


# =========================================================================
# Role attachment API
# =========================================================================


def set_overlay(role: Role, scheduler: str, overlay: Mapping[str, Any]) -> None:
    """Attach a validated raw-request patch for ``scheduler`` to the
    role (applied by that backend at dryrun)."""
    errors = validate_overlay(overlay)
    if errors:
        raise ValueError("invalid overlay:\n  " + "\n  ".join(errors))
    role.metadata.setdefault(OVERLAY_METADATA_KEY, {})[scheduler] = dict(overlay)


def get_overlay(role: Role, scheduler: str) -> Optional[dict[str, Any]]:
    """The role's overlay for ``scheduler``, or None."""
    return role.metadata.get(OVERLAY_METADATA_KEY, {}).get(scheduler)
