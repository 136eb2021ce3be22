"""The control plane's watch streams.

The port's copy of the part of :mod:`torchx_tpu.control` that the
schedulers need: every scheduler exposes ``watch(app_ids)`` -> a
:class:`~torchx_tpu_torch.control.watch.Watcher` whose ``events()`` yield
one :class:`~torchx_tpu_torch.control.events.StateEvent` per observed state
transition. The local backend watches its exit-code and state sidecars by
mtime, GKE shims ``kubectl get -w``, and everything else gets a coalesced
poll adapter. Confirming reads route through each backend's resilient
describe seam and emit ``launcher.watch`` spans.

The rest of the JAX package's control plane (the client, the daemon, the
reconciler and the job-state store) comes with its own layer (ROADMAP queue
1 item 2.7). Everything here is standard library only.
"""

from torchx_tpu_torch.control.events import StateEvent, event_from_describe
from torchx_tpu_torch.control.watch import PollWatcher, Watcher, watch_interval

__all__ = [
    "PollWatcher",
    "StateEvent",
    "Watcher",
    "event_from_describe",
    "watch_interval",
]
