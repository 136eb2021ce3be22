"""Pluggable telemetry destinations: the port of
:mod:`torchx_tpu.runner.events.handlers` (reference analog:
torchx/runner/events/handlers.py).

The events logger routes through one handler chosen by
$TPX_EVENT_DESTINATION: "null" (default — drop), "console"/"log" (stderr),
"jsonl" (durable trace sink under ~/.torchx_tpu/obs/<session>/), "prom"
(Prometheus textfile metrics flusher). Organizations register richer
destinations (e.g. a BigQuery or Cloud Logging shipper) with
:func:`register_destination` or the port's ``tpx_torch.event_handlers``
entry-point group (a handler of the JAX launcher's ``tpx.event_handlers``
is not loaded).
"""

from __future__ import annotations

import logging
import sys
from typing import Callable


def _jsonl_handler() -> logging.Handler:
    from torchx_tpu_torch.obs.sinks import JsonlTraceHandler

    return JsonlTraceHandler()


def _prom_handler() -> logging.Handler:
    from torchx_tpu_torch.obs.sinks import PromMetricsHandler

    return PromMetricsHandler()


_DESTINATIONS: dict[str, Callable[[], logging.Handler]] = {
    "null": logging.NullHandler,
    "console": lambda: logging.StreamHandler(sys.stderr),
    "log": lambda: logging.StreamHandler(sys.stderr),
    # durable obs sinks (lazy imports: handlers.py must stay import-light)
    "jsonl": _jsonl_handler,
    "prom": _prom_handler,
}

# Entry-point factories already resolved once: load_group re-reads the
# installed-distribution metadata on every call, which is milliseconds of
# filesystem work — far too slow to repeat per get_events_logger miss.
_RESOLVED_EP_FACTORIES: dict[str, Callable[[], logging.Handler]] = {}


def register_destination(name: str, factory: Callable[[], logging.Handler]) -> None:
    _DESTINATIONS[name] = factory


def get_destination_handler(dest: str) -> logging.Handler:
    factory = _DESTINATIONS.get(dest) or _RESOLVED_EP_FACTORIES.get(dest)
    if factory is None:
        from torchx_tpu_torch.util.entrypoints import load_group

        ep = load_group("tpx_torch.event_handlers").get(dest)
        if ep is not None:
            try:
                factory = ep()
            except Exception as e:  # noqa: BLE001 - fall back to null
                logging.getLogger(__name__).warning(
                    "event destination %r failed to load (%s);"
                    " telemetry will be dropped",
                    dest,
                    e,
                )
                factory = None
            else:
                # cache successes only: a broken handler should be retried
                # (and re-warned about) on the next resolution
                _RESOLVED_EP_FACTORIES[dest] = factory
    if factory is None:
        factory = logging.NullHandler
    try:
        return factory()
    except Exception as e:  # noqa: BLE001 - telemetry must never break clients
        logging.getLogger(__name__).warning(
            "event handler %r failed to construct (%s); dropping telemetry",
            dest,
            e,
        )
        return logging.NullHandler()
