"""Telemetry event model: the port of :mod:`torchx_tpu.runner.events.api`
(reference analog: torchx/runner/events/api.py:24-58)."""

from __future__ import annotations

import json
from dataclasses import asdict, dataclass, fields
from typing import Optional


@dataclass
class TpxEvent:
    """One client-API telemetry record.

    ``trace_id``/``span_id`` correlate the event with the active
    :class:`~torchx_tpu_torch.obs.trace.Span` (stamped at emit by
    :func:`~torchx_tpu_torch.runner.events.record`), so the JSONL sink's events
    attach to the right node of the ``tpx trace`` timeline.
    """

    session: str
    scheduler: str
    api: str
    app_id: Optional[str] = None
    app_image: Optional[str] = None
    app_metadata: Optional[dict] = None
    runcfg: Optional[str] = None
    source: str = "UNKNOWN"
    cpu_time_usec: Optional[int] = None
    wall_time_usec: Optional[int] = None
    start_epoch_time_usec: Optional[int] = None
    raw_exception: Optional[str] = None
    exception_type: Optional[str] = None
    exception_source_location: Optional[str] = None
    trace_id: Optional[str] = None
    span_id: Optional[str] = None

    def __str__(self) -> str:
        return self.serialize()

    def serialize(self) -> str:
        return json.dumps(asdict(self))

    @staticmethod
    def deserialize(data: str) -> "TpxEvent":
        """Parse a serialized event, dropping unknown fields — an old
        reader must survive records written by a newer emitter (the JSONL
        sink persists events across versions)."""
        obj = json.loads(data)
        known = {f.name for f in fields(TpxEvent)}
        return TpxEvent(**{k: v for k, v in obj.items() if k in known})
