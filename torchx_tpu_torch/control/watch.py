"""Watch adapters: one event interface over every scheduler backend.

The port's copy of :mod:`torchx_tpu.control.watch`.

``Scheduler.watch(app_ids)`` returns a :class:`Watcher` whose
``events()`` iterator yields a :class:`~torchx_tpu_torch.control.events
.StateEvent` per observed state *transition*. Three adapters implement
it:

* :class:`LocalSidecarWatcher` — the local backend's processes already
  leave durable traces next to their logs (the ``.tpx_state.json`` state
  file and the ``exitcode`` sidecars the ``/bin/sh`` launch wrapper
  writes), so the watcher mtime-polls those tiny files and only issues a
  *confirming* ``describe`` when something changed. Watching N local jobs
  costs N ``stat`` calls per tick and ~one describe per transition —
  not one describe per caller per tick.
* :class:`KubectlWatcher` — shims ``kubectl get -w -o json`` (one stream
  per namespace, shared by every watched JobSet in it) and parses the
  streamed objects; terminal transitions are confirmed with a describe so
  classification (preemption vs failure) stays authoritative. When
  kubectl is unavailable the affected apps degrade to the poll scan.
* :class:`PollWatcher` — the generic fallback: a coalesced describe scan
  per tick. Still a win over per-caller polling because the reconciler
  owns ONE such stream per backend regardless of how many waiters ride it.

Confirming reads go through each backend's existing ``describe`` path,
which is already routed through the resilient seam (retries, breakers,
fault injection) — a watcher never invents a second control-plane path.
Every emitted event carries a ``launcher.watch`` span and increments
``tpx_watch_events_total``.
"""

from __future__ import annotations

import json
import logging
import os
import subprocess
import threading
from typing import Any, Callable, Iterable, Iterator, Optional

from torchx_tpu_torch import settings
from torchx_tpu_torch.control.events import StateEvent, event_from_describe
from torchx_tpu_torch.obs import metrics as obs_metrics
from torchx_tpu_torch.obs import trace as obs_trace
from torchx_tpu_torch.specs.api import AppState, is_terminal

logger = logging.getLogger(__name__)


def watch_interval() -> float:
    """Tick interval for watch scans: ``$TPX_WATCH_INTERVAL`` else the
    default; malformed values fall back, with a floor keeping a bad env
    from busy-spinning the scan loop."""
    raw = os.environ.get(settings.ENV_TPX_WATCH_INTERVAL)
    if raw is None or not raw.strip():
        return settings.DEFAULT_WATCH_INTERVAL
    try:
        return max(0.01, float(raw))
    except ValueError:
        return settings.DEFAULT_WATCH_INTERVAL


def _watch_done(state: AppState) -> bool:
    """True when there is nothing left to watch for an app: a terminal
    state, or UNKNOWN (the backend no longer knows the id)."""
    return is_terminal(state) or state == AppState.UNKNOWN


class Watcher:
    """Base watch stream over a dynamic set of app ids on ONE scheduler.

    Subclasses implement :meth:`_scan` (one cheap pass over the active
    set, returning confirmed transitions). The base class owns the tick
    loop, transition dedup, span/metric emission, dynamic :meth:`add`,
    and :meth:`close` (which wakes a sleeping scan immediately).
    """

    #: event-source tag stamped on everything this adapter emits.
    source = "poll"

    def __init__(
        self,
        scheduler: Any,
        app_ids: Iterable[str] = (),
        interval: Optional[float] = None,
    ) -> None:
        self._sched = scheduler
        self._interval = interval if interval is not None else watch_interval()
        self._lock = threading.Lock()
        # app_id -> last emitted state (None = nothing emitted yet)
        self._active: dict[str, Optional[AppState]] = {}
        self._wake = threading.Event()
        self._closed = False
        for app_id in app_ids:
            self._active[app_id] = None

    @property
    def backend(self) -> str:
        """The scheduler backend this watcher streams events for."""
        return getattr(self._sched, "backend", "unknown")

    def add(self, app_id: str) -> None:
        """Start watching one more app (thread-safe, wakes the scan)."""
        with self._lock:
            if app_id not in self._active:
                self._active[app_id] = None
        self._wake.set()

    def close(self) -> None:
        """Stop the stream; a blocked ``events()`` iterator returns."""
        self._closed = True
        self._wake.set()

    # -- transition bookkeeping -------------------------------------------

    def _watching(self) -> list[tuple[str, Optional[AppState]]]:
        with self._lock:
            return [
                (app_id, last)
                for app_id, last in self._active.items()
                if last is None or not _watch_done(last)
            ]

    def _transition(self, event: StateEvent) -> Optional[StateEvent]:
        """Dedup: returns the event iff it changes the app's last emitted
        state; records the new state either way."""
        with self._lock:
            last = self._active.get(event.app_id)
            if last == event.state:
                return None
            self._active[event.app_id] = event.state
        return event

    # -- the stream --------------------------------------------------------

    def events(self, follow: bool = False) -> Iterator[StateEvent]:
        """Yield state transitions as they are observed.

        With ``follow=False`` the stream ends once every tracked app has
        reached a terminal (or UNKNOWN) state; with ``follow=True`` it
        runs until :meth:`close` — the reconciler's mode, where new apps
        keep arriving via :meth:`add`.
        """
        while not self._closed:
            try:
                transitions = self._scan()
            except Exception as e:  # noqa: BLE001 - a watch stream must not die
                logger.warning(
                    "%s watch scan failed (%s); stream continues", self.backend, e
                )
                transitions = []
            for event in transitions:
                obs_metrics.WATCH_EVENTS.inc(
                    scheduler=self.backend, source=event.source
                )
                obs_trace.heartbeat(
                    "launcher.watch",
                    scheduler=self.backend,
                    app_id=event.app_id,
                    state=event.state.name,
                    source=event.source,
                )
                yield event
            if not follow and not self._watching():
                return
            self._wake.wait(self._interval)
            self._wake.clear()

    # -- subclass hook ------------------------------------------------------

    def _describe(self, app_id: str):
        """One confirming describe through the backend's (resilient)
        describe path; errors are absorbed — the stream keeps watching."""
        try:
            return self._sched.describe(app_id)
        except Exception as e:  # noqa: BLE001 - transient control-plane wobble
            logger.debug("watch describe of %s failed: %s", app_id, e)
            return _DESCRIBE_FAILED

    def _scan(self) -> list[StateEvent]:
        """One pass over the active set -> confirmed transition events."""
        out = []
        for app_id, _last in self._watching():
            resp = self._describe(app_id)
            if resp is _DESCRIBE_FAILED:
                continue
            event = self._transition(
                event_from_describe(self.backend, app_id, resp, source=self.source)
            )
            if event is not None:
                out.append(event)
        return out


#: sentinel distinguishing "describe raised" (keep watching, state
#: unknown-but-probably-fine) from "describe returned None" (the backend
#: genuinely forgot the app -> UNKNOWN, stop watching).
_DESCRIBE_FAILED = object()


class PollWatcher(Watcher):
    """The generic poll-adapter fallback — :class:`Watcher`'s default scan
    as a concrete, importable class (what ``Scheduler.watch`` returns for
    backends without a native event source)."""

    source = "poll"


# =========================================================================
# Local: sidecar mtime watcher
# =========================================================================


class LocalSidecarWatcher(Watcher):
    """Event source for the local scheduler's on-disk traces.

    Per tick, per app: ``stat`` the state file (external cancels and
    owner state writes bump its mtime) and count the per-replica
    ``exitcode`` sidecars (the launch wrapper writes one the instant a
    replica exits, with no describe anywhere in the path). Only when one
    of those cheap signals changes does the watcher issue a confirming
    ``describe`` — which is also what lets the owning scheduler run its
    fail-fast / preemption-drill / elastic-restart bookkeeping.
    """

    source = "sidecar"

    def __init__(
        self,
        scheduler: Any,
        app_ids: Iterable[str] = (),
        interval: Optional[float] = None,
    ) -> None:
        super().__init__(scheduler, app_ids, interval=interval)
        # app_id -> (log_dir, last state-file mtime, last sidecar count)
        self._traces: dict[str, tuple[Optional[str], float, int]] = {}

    def _log_dir(self, app_id: str) -> Optional[str]:
        app = getattr(self._sched, "_apps", {}).get(app_id)
        if app is not None:
            return app.log_dir
        from torchx_tpu_torch.schedulers.local_scheduler import _registry_lookup

        return _registry_lookup(app_id)

    def _sidecar_signal(self, app_id: str, log_dir: str) -> tuple[float, int, int]:
        """(state-file mtime, completed-sidecar count, replica total) for
        one app — the cheap change detector. Missing files read as
        (0, 0, 0)."""
        from torchx_tpu_torch.schedulers.local_scheduler import (
            EXITCODE_FILE,
            STATE_FILE,
        )

        state_path = os.path.join(log_dir, STATE_FILE)
        try:
            mtime = os.stat(state_path).st_mtime
        except OSError:
            return 0.0, 0, 0
        count = total = 0
        try:
            with open(state_path) as f:
                payload = json.load(f)
        except (OSError, ValueError):
            return mtime, 0, 0
        for role_name, replicas in payload.get("roles", {}).items():
            for r in replicas:
                total += 1
                rc = os.path.join(
                    log_dir, role_name, str(r.get("id", 0)), EXITCODE_FILE
                )
                if os.path.exists(rc):
                    count += 1
        return mtime, count, total

    def _scan(self) -> list[StateEvent]:
        out = []
        for app_id, last in self._watching():
            cached = self._traces.get(app_id)
            log_dir = cached[0] if cached else self._log_dir(app_id)
            if log_dir is None:
                # nothing on disk yet (or a foreign id): describe decides
                resp = self._describe(app_id)
                if resp is _DESCRIBE_FAILED:
                    continue
                event = self._transition(
                    event_from_describe(self.backend, app_id, resp, self.source)
                )
                if event is not None:
                    out.append(event)
                continue
            mtime, sidecars, total = self._sidecar_signal(app_id, log_dir)
            changed = (
                cached is None
                or last is None
                or mtime != cached[1]
                or sidecars != cached[2]
            )
            if not changed:
                continue
            resp = self._describe(app_id)
            if resp is _DESCRIBE_FAILED:
                continue
            if resp is not None and not _watch_done(resp.state) and (
                total and sidecars >= total
            ):
                # reap race: every replica's exit sidecar is already on
                # disk but the owner has not reaped the processes, so
                # describe still says RUNNING. Do NOT record the signal —
                # the next tick re-describes until the state catches up
                # (recording it here would mean nothing ever changes again
                # and the terminal event is lost).
                pass
            else:
                self._traces[app_id] = (log_dir, mtime, sidecars)
            event = self._transition(
                event_from_describe(self.backend, app_id, resp, self.source)
            )
            if event is not None:
                out.append(event)
        return out


# =========================================================================
# GKE: kubectl watch shim
# =========================================================================


def _iter_json_docs(chunks: Iterable[str]) -> Iterator[dict]:
    """Incrementally parse a stream of concatenated JSON documents (what
    ``kubectl get -w -o json`` emits): brace-depth tracking, quote/escape
    aware, garbage between documents skipped."""
    depth = 0
    in_str = False
    escape = False
    buf: list[str] = []
    for chunk in chunks:
        for ch in chunk:
            if depth == 0 and ch != "{":
                continue  # inter-document noise
            buf.append(ch)
            if in_str:
                if escape:
                    escape = False
                elif ch == "\\":
                    escape = True
                elif ch == '"':
                    in_str = False
                continue
            if ch == '"':
                in_str = True
            elif ch == "{":
                depth += 1
            elif ch == "}":
                depth -= 1
                if depth == 0:
                    try:
                        yield json.loads("".join(buf))
                    except ValueError:
                        pass
                    buf = []


def jobset_watch_state(doc: dict) -> AppState:
    """Minimal JobSet-object -> AppState mapping for watch-line triage
    (terminal lines are re-confirmed through ``describe``, which owns the
    full classification)."""
    conditions = (doc.get("status") or {}).get("conditions") or []
    for cond in conditions:
        if str(cond.get("status", "")).lower() != "true":
            continue
        ctype = str(cond.get("type", ""))
        if ctype == "Completed":
            return AppState.SUCCEEDED
        if ctype in ("Failed", "FailurePolicyComplete"):
            return AppState.FAILED
        if ctype == "Suspended":
            return AppState.PENDING
    return AppState.RUNNING


class KubectlWatcher(Watcher):
    """``kubectl get jobsets -w`` shim: one streaming subprocess per
    namespace, shared by every watched JobSet in it.

    A reader thread per namespace feeds parsed objects into a queue the
    scan drains; terminal-looking lines trigger one confirming describe.
    If kubectl cannot be spawned the namespace's apps silently degrade to
    the inherited poll scan — same events, poll-interval latency.
    """

    source = "kubectl"

    def __init__(
        self,
        scheduler: Any,
        app_ids: Iterable[str] = (),
        interval: Optional[float] = None,
        spawn: Optional[Callable[[list[str]], Any]] = None,
    ) -> None:
        super().__init__(scheduler, app_ids, interval=interval)
        self._spawn = spawn or self._default_spawn
        self._procs: dict[str, Any] = {}  # namespace -> proc
        self._poll_fallback: set[str] = set()  # namespaces without kubectl
        self._pending: "list[tuple[str, AppState]]" = []
        self._pending_lock = threading.Lock()

    @staticmethod
    def _default_spawn(cmd: list[str]) -> Any:
        return subprocess.Popen(
            cmd,
            stdout=subprocess.PIPE,
            stderr=subprocess.DEVNULL,
            text=True,
        )

    @staticmethod
    def _split(app_id: str) -> tuple[str, str]:
        namespace, _, name = app_id.partition(":")
        return (namespace, name) if name else ("default", app_id)

    def _ensure_stream(self, namespace: str) -> None:
        if namespace in self._procs or namespace in self._poll_fallback:
            return
        cmd = [
            "kubectl",
            "get",
            "jobsets.jobset.x-k8s.io",
            "-n",
            namespace,
            "-w",
            "-o",
            "json",
        ]
        try:
            proc = self._spawn(cmd)
        except OSError as e:
            logger.warning(
                "kubectl watch unavailable for namespace %s (%s);"
                " falling back to the poll adapter",
                namespace,
                e,
            )
            self._poll_fallback.add(namespace)
            return
        self._procs[namespace] = proc
        t = threading.Thread(
            target=self._pump,
            args=(namespace, proc),
            daemon=True,
            name=f"tpx-watch-{namespace}",
        )
        t.start()

    def _pump(self, namespace: str, proc: Any) -> None:
        stdout = getattr(proc, "stdout", None)
        if stdout is None:
            self._poll_fallback.add(namespace)
            return
        try:
            for doc in _iter_json_docs(stdout):
                name = ((doc.get("metadata") or {}).get("name")) or ""
                if not name:
                    continue
                app_id = f"{namespace}:{name}"
                with self._pending_lock:
                    self._pending.append((app_id, jobset_watch_state(doc)))
                self._wake.set()
        except Exception as e:  # noqa: BLE001 - stream death -> poll fallback
            logger.warning("kubectl watch stream for %s died: %s", namespace, e)
        finally:
            self._procs.pop(namespace, None)
            self._poll_fallback.add(namespace)
            self._wake.set()

    def _scan(self) -> list[StateEvent]:
        watched = {app_id for app_id, _ in self._watching()}
        for app_id in watched:
            self._ensure_stream(self._split(app_id)[0])
        with self._pending_lock:
            pending, self._pending = self._pending, []
        out = []
        seen: set[str] = set()
        for app_id, state in pending:
            if app_id not in watched or app_id in seen:
                continue
            if _watch_done(state):
                # terminal per the stream: confirm through describe so the
                # event carries the authoritative classification
                seen.add(app_id)
                resp = self._describe(app_id)
                if resp is _DESCRIBE_FAILED:
                    continue
                event = self._transition(
                    event_from_describe(self.backend, app_id, resp, self.source)
                )
            else:
                event = self._transition(
                    StateEvent(
                        scheduler=self.backend,
                        app_id=app_id,
                        state=state,
                        source=self.source,
                    )
                )
            if event is not None:
                out.append(event)
        # namespaces without a live stream degrade to the poll scan
        for app_id, _last in self._watching():
            if self._split(app_id)[0] not in self._poll_fallback:
                continue
            if app_id in seen:
                continue
            resp = self._describe(app_id)
            if resp is _DESCRIBE_FAILED:
                continue
            event = self._transition(
                event_from_describe(self.backend, app_id, resp, source="poll")
            )
            if event is not None:
                out.append(event)
        return out

    def close(self) -> None:
        for proc in list(self._procs.values()):
            try:
                proc.terminate()
            except Exception:  # noqa: BLE001
                pass
        super().close()
