"""The control plane's unit of work: one observed app state transition.

The port's copy of :mod:`torchx_tpu.control.events`.

A :class:`StateEvent` is what every watch adapter emits and what the
reconciler consumes. It carries the scheduler's authoritative
:class:`~torchx_tpu_torch.schedulers.api.DescribeAppResponse` when the watcher
confirmed the transition with a describe (the reconciler then refreshes
the describe cache through its writer path); stream-only transitions
(e.g. a kubectl watch line) ship without one and the reconciler
invalidates instead, so the next reader re-fetches.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional

from torchx_tpu_torch.schedulers.api import DescribeAppResponse
from torchx_tpu_torch.specs.api import AppState, is_terminal
from torchx_tpu_torch.util.times import epoch_usec


@dataclass
class StateEvent:
    """One observed state transition of one app.

    Attributes:
        scheduler: backend name the app runs on.
        app_id: backend app id.
        state: the state the app transitioned TO.
        source: which adapter observed it — ``"sidecar"`` (local mtime
            watch), ``"kubectl"`` (GKE watch shim), or ``"poll"`` (the
            generic adapter).
        time_usec: observation wall-clock stamp.
        resp: the confirming describe response, when the adapter made one
            (terminal transitions always do).
        cell: federation cell the observing control daemon belongs to
            (empty outside a daemon / in single-cell direct mode). Makes
            every journal record cell-addressable, so merged multi-cell
            journals stay attributable.
    """

    scheduler: str
    app_id: str
    state: AppState
    source: str = "poll"
    time_usec: int = field(default_factory=epoch_usec)
    resp: Optional[DescribeAppResponse] = None
    cell: str = ""

    @property
    def terminal(self) -> bool:
        """True when ``state`` is terminal (the watch stream ends here)."""
        return is_terminal(self.state)

    def serialize(self) -> dict:
        """JSONL-safe record (the JobStateStore's line format). The
        ``cell`` key is written only when set, so single-cell journals
        keep their pre-federation byte format."""
        doc = {
            "scheduler": self.scheduler,
            "app_id": self.app_id,
            "state": self.state.name,
            "source": self.source,
            "time_usec": self.time_usec,
        }
        if self.cell:
            doc["cell"] = self.cell
        return doc

    @staticmethod
    def deserialize(doc: dict) -> "StateEvent":
        """Inverse of :meth:`serialize`; unknown state names degrade to
        UNKNOWN (a newer writer's line must not break rehydration)."""
        try:
            state = AppState[doc.get("state", "UNKNOWN")]
        except KeyError:
            state = AppState.UNKNOWN
        return StateEvent(
            scheduler=str(doc.get("scheduler", "")),
            app_id=str(doc.get("app_id", "")),
            state=state,
            source=str(doc.get("source", "poll")),
            time_usec=int(doc.get("time_usec", 0) or 0),
            cell=str(doc.get("cell", "")),
        )


def event_from_describe(
    scheduler: str,
    app_id: str,
    resp: Optional[DescribeAppResponse],
    source: str = "poll",
) -> StateEvent:
    """Build the event for one describe result; ``None`` (backend no
    longer knows the id) maps to UNKNOWN, which is treated as terminal
    for watch purposes — there is nothing left to watch."""
    if resp is None:
        return StateEvent(
            scheduler=scheduler, app_id=app_id, state=AppState.UNKNOWN, source=source
        )
    return StateEvent(
        scheduler=scheduler,
        app_id=app_id,
        state=resp.state,
        source=source,
        resp=resp,
    )
