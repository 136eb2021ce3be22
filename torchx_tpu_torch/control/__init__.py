"""Fleet-scale control plane: watch streams, one reconciler, one daemon
(the port's copy of :mod:`torchx_tpu.control`).

The pre-control-plane launcher polls per caller: every ``Runner.wait``
loop, every ``tpx-torch status`` script, and every supervisor sleeps-and-polls
``describe`` on its own schedule, so N callers watching M jobs cost
N x M control-plane call streams. This package inverts that into an
event-driven pyramid:

* **Watch streams** (:mod:`~torchx_tpu_torch.control.watch`) — every scheduler
  exposes ``watch(app_ids) -> StateEvent iterator`` through one interface:
  the local backend watches its exit-code/state sidecars by mtime, GKE
  shims ``kubectl get -w``, and everything else gets a coalesced
  poll-adapter fallback. All confirming reads route through the existing
  resilient describe seam and emit ``launcher.watch`` spans.
* **Reconciler** (:mod:`~torchx_tpu_torch.control.reconciler`) — a single event
  loop owns all watch streams, journals transitions into a sharded
  on-disk :class:`~torchx_tpu_torch.control.store.JobStateStore`, refreshes the
  Runner's describe cache through its writer path, and wakes
  ``Runner.wait`` / supervisor waiters via condition variables instead of
  per-caller polling.
* **Daemon** (:mod:`~torchx_tpu_torch.control.daemon`) — ``tpx-torch control``, a
  localhost HTTP daemon exposing submit/status/list/cancel/wait/log over
  JSON with per-session auth tokens and per-tenant concurrency caps. The
  CLI proxies through it transparently when ``$TPX_CONTROL_ADDR`` is set
  (:mod:`~torchx_tpu_torch.control.client`) and falls back to direct-runner
  mode otherwise.

Everything in this package is standard library only (no torch), so the daemon and
any proxying CLI stay off the heavy import path.
"""

from torchx_tpu_torch.control.client import ControlClient, ControlClientError, maybe_client
from torchx_tpu_torch.control.daemon import ControlDaemon
from torchx_tpu_torch.control.events import StateEvent, event_from_describe
from torchx_tpu_torch.control.reconciler import Reconciler
from torchx_tpu_torch.control.store import JobStateStore
from torchx_tpu_torch.control.watch import PollWatcher, Watcher, watch_interval

__all__ = [
    "ControlClient",
    "ControlClientError",
    "ControlDaemon",
    "JobStateStore",
    "PollWatcher",
    "Reconciler",
    "StateEvent",
    "Watcher",
    "event_from_describe",
    "maybe_client",
    "watch_interval",
]
