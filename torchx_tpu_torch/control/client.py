"""HTTP client for the ``tpx-torch control`` daemon — the CLI's proxy
seam (the port's copy of :mod:`torchx_tpu.control.client`).

When ``$TPX_CONTROL_ADDR`` is set (or a live daemon's discovery file is
found under ``$TPX_CONTROL_DIR``), :func:`maybe_client` returns a
:class:`ControlClient` and the CLI routes submit/status/list/cancel/wait/
log verbs through the daemon instead of driving schedulers directly —
thousands of shells then share one reconciler. When neither is present it
returns None and the CLI falls back to direct-runner mode, byte-for-byte
the pre-daemon behavior.

stdlib-only (urllib), so the proxy path adds nothing to the CLI's
import cost — ``tpx-torch --help`` stays jax-free with the daemon registered.
"""

from __future__ import annotations

import json
import os
import random
import time
import urllib.error
import urllib.request
from typing import Callable, Iterator, Optional

from torchx_tpu_torch import settings

DEFAULT_TIMEOUT = 30.0


class ControlClientError(RuntimeError):
    """A daemon request failed; carries the HTTP status (0 = transport)."""

    def __init__(self, code: int, message: str) -> None:
        super().__init__(message)
        self.code = code
        self.message = message


class _Throttled(Exception):
    """Internal: a 429 with its (capped) Retry-After hint attached."""

    def __init__(self, message: str, retry_after: float) -> None:
        super().__init__(message)
        self.message = message
        self.retry_after = retry_after


class ControlClient:
    """Thin JSON-over-HTTP wrapper mirroring the daemon's verb set.

    Throttling (HTTP 429) is absorbed here: the daemon has always sent a
    ``Retry-After`` header plus a ``retry_after_seconds`` body field with
    its 429s, and the client honors them — capped, jittered sleep, then
    retry, up to ``retry_429`` attempts — instead of bouncing the error
    to every caller. A 429'd request was *refused*, never executed, so
    the replay is idempotent by construction. ``sleep``/``rng`` are
    injectable so tests assert the backoff without wall time.
    """

    def __init__(
        self,
        addr: str,
        token: str,
        timeout: float = DEFAULT_TIMEOUT,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
        rng: Optional[random.Random] = None,
        retry_429: int = settings.CONTROL_429_MAX_RETRIES,
    ) -> None:
        self.addr = addr.rstrip("/")
        self.token = token
        self.timeout = timeout
        self.retry_429 = max(0, int(retry_429))
        self._clock = clock
        self._sleep = sleep
        self._rng = rng or random.Random()

    # -- plumbing ----------------------------------------------------------

    def _retry_after(self, err: urllib.error.HTTPError, body: dict) -> float:
        """The daemon's throttle hint, header first (the HTTP-standard
        spelling), body field second, default third — capped so a bogus
        hint cannot park the caller."""
        raw = err.headers.get("Retry-After") if err.headers else None
        if raw is None:
            raw = body.get("retry_after_seconds")
        try:
            hint = float(raw) if raw is not None else float(
                settings.CONTROL_RETRY_AFTER_SECONDS
            )
        except (TypeError, ValueError):
            hint = float(settings.CONTROL_RETRY_AFTER_SECONDS)
        return max(0.0, min(hint, settings.CONTROL_429_RETRY_CAP_SECONDS))

    def _request(
        self,
        path: str,
        payload: Optional[dict] = None,
        timeout: Optional[float] = None,
    ) -> dict:
        attempt = 0
        while True:
            try:
                return self._request_once(path, payload, timeout)
            except _Throttled as t:
                if attempt >= self.retry_429:
                    raise ControlClientError(429, t.message) from t
                attempt += 1
                # ±10% jitter so N throttled clients don't re-dial in
                # one synchronized wave when the hint expires
                self._sleep(
                    t.retry_after * (1.0 + self._rng.uniform(-0.1, 0.1))
                )

    def _request_once(
        self,
        path: str,
        payload: Optional[dict] = None,
        timeout: Optional[float] = None,
    ) -> dict:
        req = urllib.request.Request(
            self.addr + path,
            data=None if payload is None else json.dumps(payload).encode(),
            headers={
                "Authorization": f"Bearer {self.token}",
                "Content-Type": "application/json",
            },
            method="GET" if payload is None else "POST",
        )
        try:
            with urllib.request.urlopen(
                req, timeout=timeout or self.timeout
            ) as resp:
                return json.loads(resp.read() or b"{}")
        except urllib.error.HTTPError as e:
            try:
                body = json.loads(e.read() or b"{}")
                message = body.get("error", str(e))
            except ValueError:
                body, message = {}, str(e)
            if e.code == 429:
                raise _Throttled(message, self._retry_after(e, body)) from e
            raise ControlClientError(e.code, message) from e
        except (urllib.error.URLError, OSError, ValueError) as e:
            raise ControlClientError(0, f"control daemon unreachable: {e}") from e

    # -- verbs -------------------------------------------------------------

    def healthz(self) -> dict:
        """Liveness probe: the daemon's version, uptime, and stream count."""
        return self._request("/healthz")

    def mint_session(self, tenant: str) -> str:
        """Mint a per-tenant session token (root-token callers only)."""
        return str(self._request("/v1/session", {"tenant": tenant})["token"])

    def submit_job(
        self,
        component: str,
        args: list[str],
        scheduler: str,
        cfg: Optional[dict] = None,
        cfg_str: str = "",
        workspace: Optional[str] = None,
        priority: Optional[str] = None,
        elastic: bool = False,
        mesh: str = "",
        replicas: Optional[int] = None,
        chips: Optional[int] = None,
        min_replicas: Optional[int] = None,
    ) -> dict:
        """Submit through the daemon, returning the full reply.

        In daemon-only mode the reply is ``{"handle"}``; with the fleet
        scheduler enabled it may instead be ``{"queued": true,
        "fleet_job", "position"}``. The fleet fields (``priority``,
        ``elastic``, ``mesh``, ``replicas``/``chips`` overrides,
        ``min_replicas``) are ignored by a daemon without a fleet."""
        payload: dict = {
            "component": component,
            "args": list(args),
            "scheduler": scheduler,
            "cfg": dict(cfg or {}),
            "cfg_str": cfg_str,
            "workspace": workspace,
            "elastic": bool(elastic),
            "mesh": mesh,
        }
        if priority is not None:
            payload["priority"] = priority
        if replicas is not None:
            payload["replicas"] = int(replicas)
        if chips is not None:
            payload["chips"] = int(chips)
        if min_replicas is not None:
            payload["min_replicas"] = int(min_replicas)
        return self._request("/v1/submit", payload)

    def submit(
        self,
        component: str,
        args: list[str],
        scheduler: str,
        cfg: Optional[dict] = None,
        cfg_str: str = "",
        workspace: Optional[str] = None,
    ) -> str:
        """Submit through the daemon. ``cfg_str`` ships the CLI's raw
        ``-cfg k=v,...`` string so the daemon parses it against the
        backend's typed runopts schema (the client stays schema-blind).

        Callers of this verb need a handle NOW; a fleet-queued reply
        (no handle yet) surfaces as a 202-coded
        :class:`ControlClientError` naming the fleet job id."""
        reply = self.submit_job(
            component,
            args,
            scheduler,
            cfg=cfg,
            cfg_str=cfg_str,
            workspace=workspace,
        )
        handle = reply.get("handle")
        if not handle:
            raise ControlClientError(
                202,
                f"queued as {reply.get('fleet_job')} at position"
                f" {reply.get('position')}; watch with `tpx-torch queue`",
            )
        return str(handle)

    def queue(self) -> dict:
        """The fleet scheduler's queue + placement snapshot
        (``{"enabled": false}`` when the daemon has no fleet)."""
        return self._request("/v1/queue")

    def metrics_query(
        self,
        name: Optional[str] = None,
        labels: Optional[dict] = None,
        reduce: Optional[str] = None,
        range_s: Optional[float] = None,
    ) -> dict:
        """Query the daemon's telemetry plane (``/v1/metrics/query``).

        No ``name`` lists the known metric names; with one, returns the
        raw windowed series plus the reducer's per-label-set scalars
        (``reduce`` = last/sum/avg/max/min/rate/pNN)."""
        from urllib.parse import quote

        parts = []
        if name:
            parts.append(f"name={quote(name, safe='')}")
        if reduce:
            parts.append(f"reduce={quote(reduce, safe='')}")
        if range_s is not None:
            parts.append(f"range={range_s:g}")
        for k, v in (labels or {}).items():
            parts.append(f"label.{quote(k, safe='')}={quote(str(v), safe='')}")
        return self._request(
            "/v1/metrics/query" + ("?" + "&".join(parts) if parts else "")
        )

    def alerts(self) -> dict:
        """Active SLO alerts + last burn rates (``/v1/alerts``)."""
        return self._request("/v1/alerts")

    def add_scrape_target(self, url: str, name: Optional[str] = None) -> dict:
        """Register a replica ``/metricz`` URL with the daemon's
        collector; returns ``{"source", "targets"}``."""
        payload: dict = {"url": url}
        if name:
            payload["name"] = name
        return self._request("/v1/metrics/targets", payload)

    def remove_scrape_target(self, name: str) -> dict:
        """Drop a scrape target by source name."""
        return self._request("/v1/metrics/targets", {"remove": name})

    def pipeline_submit(self, spec: dict) -> dict:
        """Submit a train→eval→promote DAG (``POST /v1/pipelines``).

        ``spec`` is a :class:`~torchx_tpu_torch.pipelines.dag.PipelineSpec`
        dict (``{"name", "stages": [...]}``); returns
        ``{"pipeline": "pl_N"}``."""
        return self._request("/v1/pipelines", {"spec": spec})

    def pipeline_status(self, pipeline: Optional[str] = None) -> dict:
        """One pipeline's stage-by-stage record, or the full list +
        current incumbent when ``pipeline`` is None."""
        path = "/v1/pipelines"
        if pipeline:
            from urllib.parse import quote

            path += f"?pipeline={quote(pipeline, safe='')}"
        return self._request(path)

    def pipeline_cancel(self, pipeline: str) -> dict:
        """Cancel a running pipeline: in-flight stages are cancelled on
        their backends and the pipeline journals CANCELLED."""
        return self._request("/v1/pipelines/cancel", {"pipeline": pipeline})

    def cell_status(self) -> dict:
        """The daemon's federation-cell identity + lifecycle
        (``GET /v1/cell``): ``{"cell", "state", "draining",
        "rehydrated", "rehydration"}``."""
        return self._request("/v1/cell")

    def cell_drain(self) -> dict:
        """Begin draining this cell: in-flight work keeps running, new
        submissions are refused with 503 so a federation router spills
        them to the next-best cell."""
        return self._request("/v1/cell/drain", {})

    def cell_uncordon(self) -> dict:
        """Reopen a drained/draining cell for new traffic."""
        return self._request("/v1/cell/uncordon", {})

    def status(self, handle: str) -> dict:
        """One job's recorded state: answered from the daemon's
        reconciler journal + shared describe cache, not a fresh backend
        describe per call."""
        from urllib.parse import quote

        return self._request(f"/v1/status?handle={quote(handle, safe='')}")

    def list(self, scheduler: Optional[str] = None) -> list[dict]:
        """All jobs the daemon tracks, optionally filtered by backend."""
        path = "/v1/list"
        if scheduler:
            from urllib.parse import quote

            path += f"?scheduler={quote(scheduler, safe='')}"
        return list(self._request(path).get("apps", []))

    def cancel(self, handle: str) -> None:
        """Cancel the job on its backend (and release the tenant's slot)."""
        self._request("/v1/cancel", {"handle": handle})

    #: consecutive transport failures :meth:`wait` rides out before the
    #: error surfaces (a daemon restart drops every in-flight long-poll;
    #: the journal-rehydrated successor answers the re-issued one).
    WAIT_RECONNECT_ATTEMPTS = 10

    def wait(self, handle: str, timeout: Optional[float] = None) -> dict:
        """Block until terminal: chained bounded long-polls against
        ``/v1/wait`` (each HTTP request stays short; the daemon's
        reconciler wakes it the moment the terminal event lands).

        A transport failure mid-chain — the daemon restarting under the
        wait is the common case — is retried with capped jittered
        backoff instead of erroring: the successor daemon rehydrates its
        journal, so the re-issued poll resolves against the recorded
        (possibly already-terminal) state. Only
        :data:`WAIT_RECONNECT_ATTEMPTS` *consecutive* failures surface.
        """
        deadline = None if timeout is None else self._clock() + timeout
        from urllib.parse import quote

        transport_failures = 0
        while True:
            budget = 30.0
            if deadline is not None:
                budget = min(budget, max(0.1, deadline - self._clock()))
            try:
                payload = self._request(
                    f"/v1/wait?handle={quote(handle, safe='')}"
                    f"&timeout={budget:g}",
                    timeout=budget + 15.0,
                )
            except ControlClientError as e:
                if e.code != 0:
                    raise  # a real HTTP verdict (401/404/...) is final
                transport_failures += 1
                if transport_failures >= self.WAIT_RECONNECT_ATTEMPTS:
                    raise
                if deadline is not None and self._clock() >= deadline:
                    raise TimeoutError(
                        f"app {handle} unreachable at deadline: {e.message}"
                    ) from e
                delay = min(0.25 * (2.0 ** (transport_failures - 1)), 5.0)
                self._sleep(delay * (1.0 + self._rng.uniform(-0.1, 0.1)))
                continue
            transport_failures = 0
            if payload.get("terminal"):
                return payload
            if deadline is not None and self._clock() >= deadline:
                raise TimeoutError(
                    f"app {handle} still {payload.get('state')} after {timeout}s"
                )

    def log_lines(
        self,
        handle: str,
        role_name: str = "app",
        k: int = 0,
        tail: bool = False,
    ) -> Iterator[str]:
        """Stream one replica's log lines through the daemon (JSONL);
        ``tail=True`` follows the stream until the app finishes."""
        from urllib.parse import quote

        req = urllib.request.Request(
            f"{self.addr}/v1/logs?handle={quote(handle, safe='')}"
            f"&role={quote(role_name, safe='')}&k={int(k)}"
            f"&tail={'1' if tail else '0'}",
            headers={"Authorization": f"Bearer {self.token}"},
        )
        try:
            resp = urllib.request.urlopen(
                req, timeout=None if tail else self.timeout
            )
        except urllib.error.HTTPError as e:
            try:
                message = json.loads(e.read() or b"{}").get("error", str(e))
            except ValueError:
                message = str(e)
            raise ControlClientError(e.code, message) from e
        except (urllib.error.URLError, OSError) as e:
            raise ControlClientError(0, f"control daemon unreachable: {e}") from e
        with resp:
            for raw in resp:
                try:
                    doc = json.loads(raw)
                except ValueError:
                    continue
                if doc.get("done"):
                    return
                if "line" in doc:
                    yield str(doc["line"])


def _discovery() -> Optional[tuple[str, str]]:
    """(addr, token) from the daemon's discovery file, if one exists."""
    from torchx_tpu_torch.control.daemon import DISCOVERY_FILE, control_dir

    path = os.path.join(control_dir(), DISCOVERY_FILE)
    try:
        with open(path) as f:
            doc = json.load(f)
        addr, token = str(doc.get("addr", "")), str(doc.get("token", ""))
        if addr and token:
            return addr, token
    except (OSError, ValueError):
        pass
    return None


def maybe_client(require_env: bool = True) -> Optional[ControlClient]:
    """The CLI's proxy decision, in one place.

    ``$TPX_CONTROL_ADDR`` set -> a client for that address (token from
    ``$TPX_CONTROL_TOKEN``, else the discovery file). Unset -> None
    (direct-runner mode) unless ``require_env=False``, which also accepts
    a discovery file alone (how ``tpx-torch control status`` finds its daemon).
    """
    addr = os.environ.get(settings.ENV_TPX_CONTROL_ADDR, "").strip()
    token = os.environ.get(settings.ENV_TPX_CONTROL_TOKEN, "").strip()
    if addr:
        if not token:
            found = _discovery()
            if found is not None and found[0].rstrip("/") == addr.rstrip("/"):
                token = found[1]
        if not token:
            raise ControlClientError(
                401,
                f"{settings.ENV_TPX_CONTROL_ADDR} is set but no token: set"
                f" {settings.ENV_TPX_CONTROL_TOKEN} or run the daemon with a"
                " readable discovery file",
            )
        return ControlClient(addr, token)
    if not require_env:
        found = _discovery()
        if found is not None:
            return ControlClient(found[0], found[1])
    return None
