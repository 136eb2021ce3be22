"""``tpx-torch control`` — the multi-tenant control-plane daemon: the
port's copy of :mod:`torchx_tpu.control.daemon`, with a gang's cards
(``resource.gpu.gpus``) where the JAX daemon reads a slice's chips. The
wire and journal fields keep the JAX names (``chips``,
``chips_per_replica``), because the client and the journal speak them.

One long-lived localhost process owns a Runner, a
:class:`~torchx_tpu_torch.control.reconciler.Reconciler` (all watch streams),
and the sharded :class:`~torchx_tpu_torch.control.store.JobStateStore`, and
serves the launcher verbs over plain JSON HTTP (the stdlib
ThreadingHTTPServer idiom the serving stack already uses). Every CLI on
the machine then shares ONE describe path and ONE event stream per
backend instead of each running its own poll loop.

API (JSON; Bearer-token auth on every ``/v1`` route):

    GET  /healthz                 -> {"status": "ok", "jobs": N, ...}
    GET  /metricz                 -> tpx_* metrics, Prometheus text
    POST /v1/session  {"tenant"}  -> {"token"}          (root token only)
    POST /v1/submit   {"component", "args", "scheduler", "cfg", ...}
                                  -> {"handle"} | 429 past the tenant cap
    GET  /v1/status?handle=       -> {"state", "terminal", ...} | 404
    GET  /v1/list[?scheduler=]    -> {"apps": [...]}
    POST /v1/cancel   {"handle"}  -> {"ok": true}
    GET  /v1/wait?handle=&timeout= -> bounded long-poll; returns the
                                  status when terminal or when the budget
                                  expires ({"terminal": false})
    GET  /v1/logs?handle=&role=&k= -> JSONL line stream (log attach)
    GET  /v1/queue                -> fleet queue + placements snapshot
                                  ({"enabled": false} without --fleet)
    GET  /v1/metrics/query?name=&reduce=&range=&label.K=V
                                  -> telemetry series + reduced scalars
                                  (no ``name``: {"names": [...]})
    GET  /v1/alerts               -> active SLO alerts + last burn rates
    POST /v1/metrics/targets {"url", "name"?, "remove"?}
                                  -> register/remove a /metricz scrape
    POST /v1/pipelines {"spec"}   -> {"pipeline"}: submit a train→eval→
                                  promote DAG to the pipeline engine
    GET  /v1/pipelines[?pipeline=] -> one pipeline's full record, or all
    POST /v1/pipelines/cancel {"pipeline"} -> the cancelled record
    GET  /v1/cell                 -> federation identity + lifecycle:
                                  {"cell", "state", "draining",
                                  "rehydrated", "rehydration", "inflight"}
    POST /v1/cell/drain           -> begin draining (durable): in-flight
                                  work finishes, new submits bounce 503
    POST /v1/cell/uncordon        -> reopen a drained cell for traffic

Every daemon is one federation *cell* (``--cell``/``$TPX_CELL``,
default ``default``): journal records carry the cell name, ``/healthz``
reports rehydration progress so a router can tell "booting, journal
replaying" from "healthy", and the drain verbs drive the
HEALTHY → DRAINING → DRAINED → UNCORDONED lifecycle the
federation router (ROADMAP queue 1 item 2.8) keys off. While draining, submit
verbs (``/v1/submit``, ``/v1/pipelines``) refuse with 503 +
``{"code": "cell_draining"}`` — a deliberate *don't-retry-here* verdict:
the federation router spills the request to the next-best cell instead.

The daemon also hosts the fleet **telemetry plane**: a
:class:`~torchx_tpu_torch.obs.telemetry.Collector` scrapes registered replica
``/metricz`` targets and every obs session's textfiles into a bounded
:class:`~torchx_tpu_torch.obs.telemetry.MetricStore` (plus the daemon's own
registry, source ``control``), ``/metricz`` serves the cross-source
aggregate, and an optional :class:`~torchx_tpu_torch.obs.slo.SloEngine`
(``--slo`` specs) evaluates burn rates each cycle, journals alert
transitions to ``state_dir/slo_alerts.jsonl``, and feeds the fleet
market its SLO signal.

Security model: the daemon binds loopback only. At start it mints a root
token and records ``{"addr", "token", "pid"}`` in a 0600 discovery file
(``$TPX_CONTROL_DIR/control.json``) — same-user CLIs find the daemon
through it (:func:`torchx_tpu_torch.control.client.maybe_client`). The root
token can mint per-tenant session tokens (``/v1/session``); each tenant
is capped at ``tenant_cap`` concurrently *active* (non-terminal) jobs,
submits past the cap get 429 (with a ``Retry-After`` hint and a stable
JSON error body) and the caller's retry policy decides.

With a :class:`~torchx_tpu_torch.fleet.api.FleetScheduler` attached (``tpx
control --fleet``), ``/v1/submit`` stops bouncing: the submit is
dryrun-validated, serialized into a resubmission recipe, and handed to
the fleet queue — the reply is either ``{"handle"}`` (placed now) or
``{"queued": true, "position": N}``. The daemon implements the
scheduler's executor seam (materialize + run + reconciler tracking) and
feeds it every watch event, so a terminal job immediately re-runs the
placement loop.
"""

from __future__ import annotations

import json
import logging
import os
import secrets
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Optional
from urllib.parse import parse_qs, urlparse

from torchx_tpu_torch import settings
from torchx_tpu_torch.control.events import StateEvent
from torchx_tpu_torch.control.reconciler import Reconciler
from torchx_tpu_torch.control.store import JobStateStore
from torchx_tpu_torch.obs import metrics as obs_metrics
from torchx_tpu_torch.specs.api import AppState

logger = logging.getLogger(__name__)

DISCOVERY_FILE = "control.json"


def control_dir() -> str:
    """State root for the control plane: ``$TPX_CONTROL_DIR``, default
    ``~/.torchx_tpu_torch/control``."""
    raw = os.environ.get(settings.ENV_TPX_CONTROL_DIR)
    if raw and raw.strip():
        return raw
    return os.path.join(os.path.expanduser("~"), ".torchx_tpu_torch", "control")


class _DaemonError(Exception):
    """Maps straight to an HTTP error reply.

    ``payload`` keys are merged into the JSON error body (stable,
    machine-readable fields next to the human ``error`` string);
    ``headers`` become response headers (e.g. ``Retry-After``)."""

    def __init__(
        self,
        code: int,
        message: str,
        payload: Optional[dict] = None,
        headers: Optional[dict] = None,
    ) -> None:
        super().__init__(message)
        self.code = code
        self.message = message
        self.payload = dict(payload or {})
        self.headers = dict(headers or {})


class _FleetExecutor:
    """The daemon-side half of the fleet scheduler's executor seam.

    Re-materializes a gang's journaled recipe at its CURRENT replica
    count (shrink/grow resubmits change it), injects the fleet env
    (``$TPX_FLEET_JOB``/``CLASS`` always, ``$TPX_MESH`` on reshapes), and
    submits with ``no_lint=True`` — validation happened at submit-time
    dryrun; a reshape must not bounce off a lint gate. Called with the
    scheduler's lock held, so it never calls back into the scheduler."""

    def __init__(self, daemon: "ControlDaemon") -> None:
        self._daemon = daemon

    def schedule(self, job: Any, mesh_spec: Optional[str]) -> str:
        from torchx_tpu_torch.specs.serialize import appdef_from_dict

        daemon = self._daemon
        recipe = job.recipe
        app = appdef_from_dict(recipe["appdef"])
        scheduler = str(recipe.get("scheduler") or "local")
        if app.roles:
            app.roles[0].num_replicas = int(job.cur_replicas)
        for role in app.roles:
            role.env[settings.ENV_TPX_FLEET_JOB] = job.req.job
            role.env[settings.ENV_TPX_FLEET_CLASS] = job.req.klass
            # every attempt of a gang (first place, preempt-requeue,
            # shrink/grow reshape) joins the job's journaled trace, so
            # `tpx-torch trace --stitch <job>` sees one lifecycle timeline
            if recipe.get("trace_id"):
                role.env[settings.ENV_TPX_TRACE_ID] = str(recipe["trace_id"])
            if mesh_spec:
                role.env[settings.ENV_TPX_MESH] = mesh_spec
            else:
                role.env.pop(settings.ENV_TPX_MESH, None)
        handle = daemon.runner.run(
            app,
            scheduler,
            cfg=dict(recipe.get("cfg") or {}),
            workspace=recipe.get("workspace"),
            no_lint=True,
        )
        sched_name, app_id = daemon._split_handle(handle)
        with daemon._lock:
            daemon._jobs[handle] = job.req.tenant
        daemon.reconciler.ingest(
            StateEvent(
                scheduler=sched_name,
                app_id=app_id,
                state=AppState.SUBMITTED,
                source="fleet",
                cell=daemon.cell,
            )
        )
        daemon.reconciler.track(
            sched_name, daemon.runner._scheduler(sched_name), app_id
        )
        return handle

    def cancel(self, handle: str) -> None:
        try:
            self._daemon.runner.cancel(handle)
        except Exception as e:  # noqa: BLE001 - reshape cancel is best-effort
            logger.debug("fleet cancel of %s failed: %s", handle, e)


class _PipelineExecutor:
    """The pipeline engine's stage submitter.

    Materializes the stage component, stamps every role with the stage
    kind (``tpx/pipeline`` metadata — the TPX603 rule's anchor), and
    submits: through the fleet scheduler with the stage's priority class
    when one is attached (eval=interactive, canary=serve), else directly
    through the Runner with the same journal/track bookkeeping as
    ``/v1/submit``."""

    def __init__(self, daemon: "ControlDaemon") -> None:
        self._daemon = daemon

    def submit(
        self, tenant: str, pipeline: str, stage: Any, args: list[str]
    ) -> dict:
        from torchx_tpu_torch.pipelines.dag import ROLE_METADATA_KEY

        daemon = self._daemon
        cfg = daemon._parse_cfg(stage.scheduler, {"cfg": dict(stage.cfg)})
        info = daemon.runner.dryrun_component(
            stage.component, list(args), stage.scheduler, cfg=cfg
        )
        app = info._app
        for role in app.roles:
            role.metadata[ROLE_METADATA_KEY] = stage.kind
        if daemon.fleet is not None:
            return self._fleet_submit(tenant, stage, app, cfg)
        handle = daemon.runner.run(
            app, stage.scheduler, cfg=cfg, no_lint=True
        )
        sched_name, app_id = daemon._split_handle(handle)
        with daemon._lock:
            daemon._jobs[handle] = tenant
        daemon.reconciler.ingest(
            StateEvent(
                scheduler=sched_name,
                app_id=app_id,
                state=AppState.SUBMITTED,
                source="pipeline",
                cell=daemon.cell,
            )
        )
        daemon.reconciler.track(
            sched_name, daemon.runner._scheduler(sched_name), app_id
        )
        return {"handle": handle}

    def _fleet_submit(
        self, tenant: str, stage: Any, app: Any, cfg: dict
    ) -> dict:
        from torchx_tpu_torch.fleet.model import GangRequest
        from torchx_tpu_torch.specs.serialize import appdef_to_dict

        daemon = self._daemon
        role = app.roles[0] if app.roles else None
        gpu = role.resource.gpu if role is not None else None
        for r in app.roles:
            r.metadata["fleet/class"] = stage.priority
        gang = GangRequest(
            job="",
            tenant=tenant,
            klass=stage.priority,
            replicas=(
                int(stage.replicas)
                if int(stage.replicas) > 1
                else (role.num_replicas if role is not None else 1)
            ),
            chips_per_replica=gpu.gpus if gpu is not None else 1,
        )
        recipe = {
            "appdef": appdef_to_dict(app),
            "scheduler": stage.scheduler,
            "cfg": cfg,
            "workspace": None,
        }
        result = daemon.fleet.submit(gang, recipe)
        status = result.get("status")
        if status == "infeasible":
            raise RuntimeError(
                f"gang cannot fit this fleet: {result.get('reason')}"
            )
        if status == "placed":
            return {"handle": result.get("handle", "")}
        return {"queued": True, "fleet_job": result["job"]}

    def resolve(self, fleet_job: str) -> str:
        """Handle of a fleet-queued stage once the market placed it."""
        if self._daemon.fleet is None:
            return ""
        for entry in self._daemon.fleet.queue_snapshot().get("running", []):
            if str(entry.get("job", "")) == fleet_job:
                return str(entry.get("handle", ""))
        return ""

    def cancel(self, handle: str) -> None:
        try:
            self._daemon.runner.cancel(handle)
        except Exception as e:  # noqa: BLE001 - fail-fast cancel is best-effort
            logger.debug("pipeline cancel of %s failed: %s", handle, e)


class ControlDaemon:
    """The daemon's state + HTTP server; see the module docstring.

    Args:
        runner: the :class:`~torchx_tpu_torch.runner.api.Runner` driving the
            backends (default: a fresh ``get_runner("tpx-control")``).
        host/port: bind address — loopback by default; ``port=0`` lets
            the OS pick (read it back from :attr:`addr`).
        state_dir: discovery file + job-state store root (default
            :func:`control_dir`).
        tenant_cap: max concurrently active jobs per tenant (default
            :data:`~torchx_tpu_torch.settings.DEFAULT_CONTROL_TENANT_CAP`).
            Only enforced in daemon-only mode — with ``fleet`` attached,
            submits queue instead of bouncing.
        fleet: an optional :class:`~torchx_tpu_torch.fleet.api.FleetScheduler`;
            the daemon binds itself as its executor, subscribes it to the
            watch stream, and rehydrates its journal.
        slos: SLO spec strings/objects (see
            :func:`torchx_tpu_torch.obs.slo.parse_slo`) the telemetry plane
            evaluates each collect cycle.
        scrape_interval: collector cycle seconds (default
            ``$TPX_TELEMETRY_INTERVAL`` or
            :data:`~torchx_tpu_torch.settings.DEFAULT_TELEMETRY_INTERVAL`).
        telemetry: set False to run without the collector/SLO plane
            (``/metricz`` then serves only the daemon's own registry).
        cell: federation cell name this daemon answers as (default
            ``$TPX_CELL`` or
            :data:`~torchx_tpu_torch.settings.DEFAULT_CELL_NAME`). Stamped
            into every journal record and served on ``/v1/cell``.
    """

    def __init__(
        self,
        runner: Optional[Any] = None,
        host: str = "127.0.0.1",
        port: int = 0,
        state_dir: Optional[str] = None,
        tenant_cap: Optional[int] = None,
        fleet: Optional[Any] = None,
        slos: Optional[list] = None,
        scrape_interval: Optional[float] = None,
        telemetry: bool = True,
        pipeline_pool_provider: Optional[Any] = None,
        clock: Callable[[], float] = time.monotonic,
        cell: Optional[str] = None,
    ) -> None:
        if runner is None:
            from torchx_tpu_torch.runner.api import get_runner

            runner = get_runner("tpx-control")
        self.runner = runner
        self.clock = clock
        self.state_dir = state_dir or control_dir()
        self.cell = (
            cell
            or os.environ.get(settings.ENV_TPX_CELL, "").strip()
            or settings.DEFAULT_CELL_NAME
        )
        # rehydration status, surfaced on /healthz so a federation
        # router (and operators) can tell "booting, journal replaying"
        # from "healthy" — routers treat a not-yet-rehydrated cell as
        # drained. Flipped True as the LAST act of __init__.
        self.rehydrated = False
        self.rehydration = {
            "journal_jobs": 0,
            "fleet_reowned": 0,
            "pipelines_reowned": 0,
        }
        # drain state is durable (state_dir/cell.json): a drained cell
        # that restarts comes back drained — the operator uncordons, not
        # the crash
        self._cell_path = os.path.join(self.state_dir, "cell.json")
        self._draining = False
        try:
            with open(self._cell_path) as f:
                self._draining = bool(json.load(f).get("draining"))
        except (OSError, ValueError):
            pass
        self.tenant_cap = (
            tenant_cap
            if tenant_cap is not None
            else settings.DEFAULT_CONTROL_TENANT_CAP
        )
        self.store = JobStateStore(os.path.join(self.state_dir, "store"))
        self.rehydration["journal_jobs"] = len(self.store)
        self.reconciler = Reconciler(store=self.store, clock=clock, cell=self.cell)
        runner.attach_reconciler(self.reconciler)
        self.root_token = secrets.token_hex(16)
        self._tokens: dict[str, str] = {self.root_token: "root"}
        # handle -> tenant, for the per-tenant active-job cap. Rehydrated
        # handles (daemon restart) land under their journaled tenant.
        self._jobs: dict[str, str] = {}
        self._lock = threading.Lock()
        self._server = ThreadingHTTPServer((host, port), self._make_handler())
        self._server.daemon_threads = True
        self._thread: Optional[threading.Thread] = None
        self._serving = False
        self._closed = False
        self.telemetry_store: Optional[Any] = None
        self.collector: Optional[Any] = None
        self.slo_engine: Optional[Any] = None
        if telemetry:
            from torchx_tpu_torch.obs.slo import SloEngine, SloSpec, parse_slo
            from torchx_tpu_torch.obs.telemetry import Collector, MetricStore

            self.telemetry_store = MetricStore()
            self.collector = Collector(
                self.telemetry_store, interval_s=scrape_interval
            )
            # the daemon's own registry is a first-class source: control
            # verbs, fleet gauges, and gang-wait histograms flow through
            # obs_metrics.REGISTRY in this process
            self.collector.hooks.append(self._ingest_self)
            specs = [
                s if isinstance(s, SloSpec) else parse_slo(str(s))
                for s in (slos or [])
            ]
            self.slo_engine = SloEngine(
                self.telemetry_store,
                specs,
                journal_path=os.path.join(self.state_dir, "slo_alerts.jsonl"),
            )
            self.collector.hooks.append(lambda: self.slo_engine.evaluate())
        self.fleet = fleet
        if fleet is not None:
            if self.slo_engine is not None and hasattr(
                fleet, "set_slo_signal"
            ):
                # market input: the worst long-window burn across
                # fleet-scoped SLOs (gang wait, step time)
                engine = self.slo_engine
                fleet.set_slo_signal(
                    lambda: engine.max_burn(metric_prefix="tpx_")
                )
            fleet.bind(_FleetExecutor(self))
            self.reconciler.subscribe(fleet.on_event)
            fleet.rehydrate()
            # re-own rehydrated running jobs: tenant accounting + watch
            # tracking, so their terminal events free fleet capacity
            for entry in fleet.queue_snapshot().get("running", []):
                handle = str(entry.get("handle") or "")
                if not handle:
                    continue
                with self._lock:
                    self._jobs[handle] = str(entry.get("tenant", ""))
                try:
                    sched_name, app_id = self._split_handle(handle)
                    self.reconciler.track(
                        sched_name, runner._scheduler(sched_name), app_id
                    )
                    self.rehydration["fleet_reowned"] += 1
                except Exception as e:  # noqa: BLE001 - degrade to poll
                    logger.warning(
                        "fleet rehydrate: cannot track %s: %s", handle, e
                    )
        # the pipeline engine rides the same reconciler event stream and
        # the same journal-then-act durability contract as the fleet; it
        # is always on (a daemon without pipelines is just one that never
        # received a /v1/pipelines submit)
        from torchx_tpu_torch.pipelines.engine import PipelineEngine

        pipeline_slo = None
        if self.slo_engine is not None:
            slo_engine = self.slo_engine
            pipeline_slo = lambda: slo_engine.max_burn(  # noqa: E731
                metric_prefix="tpx_"
            )
        self.pipelines = PipelineEngine(
            os.path.join(self.state_dir, "pipelines.jsonl"),
            executor=_PipelineExecutor(self),
            reconciler=self.reconciler,
            slo_signal=pipeline_slo,
            pool_provider=pipeline_pool_provider,
        )
        self.reconciler.subscribe(self.pipelines.on_event)
        for item in self.pipelines.rehydrate():
            handle = str(item.get("handle") or "")
            if not handle:
                continue
            with self._lock:
                self._jobs[handle] = str(item.get("tenant", ""))
            try:
                self.reconciler.track(
                    item["scheduler"],
                    runner._scheduler(item["scheduler"]),
                    item["app_id"],
                )
                self.rehydration["pipelines_reowned"] += 1
            except Exception as e:  # noqa: BLE001 - degrade to poll
                logger.warning(
                    "pipeline rehydrate: cannot track %s: %s", handle, e
                )
        self.rehydrated = True
        obs_metrics.FED_CELL_STATE.set(
            float(obs_metrics.CELL_STATE_VALUES["DRAINING"])
            if self._draining
            else float(obs_metrics.CELL_STATE_VALUES["HEALTHY"]),
            cell=self.cell,
        )

    # -- lifecycle ---------------------------------------------------------

    @property
    def addr(self) -> str:
        """The daemon's base URL, e.g. ``http://127.0.0.1:PORT``."""
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}"

    def discovery_path(self) -> str:
        """Where the 0600 addr+token discovery file lives under state_dir."""
        return os.path.join(self.state_dir, DISCOVERY_FILE)

    def _write_discovery(self) -> None:
        """Record addr + root token for same-user CLIs, 0600 (the token
        IS the auth boundary between users on a shared host)."""
        os.makedirs(self.state_dir, exist_ok=True)
        path = self.discovery_path()
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(
                {"addr": self.addr, "token": self.root_token, "pid": os.getpid()},
                f,
            )
            f.flush()
            os.fsync(f.fileno())
        os.chmod(tmp, 0o600)
        os.replace(tmp, path)

    def start(self) -> "ControlDaemon":
        """Write the discovery file and serve on a background thread."""
        self._write_discovery()
        if self.collector is not None:
            self.collector.start()
        self._serving = True
        self._thread = threading.Thread(
            target=self._server.serve_forever, name="tpx-control", daemon=True
        )
        self._thread.start()
        logger.info("tpx-torch control serving on %s", self.addr)
        return self

    def serve_forever(self) -> None:
        """Foreground mode (what ``tpx-torch control`` runs)."""
        self._write_discovery()
        if self.collector is not None:
            self.collector.start()
        logger.info("tpx-torch control serving on %s", self.addr)
        self._serving = True
        try:
            self._server.serve_forever()
        finally:
            self.close()

    def close(self) -> None:
        """Stop serving, join the serve thread, close the reconciler, and
        remove the discovery file. Idempotent; safe on a never-started
        daemon."""
        if self._closed:
            return
        self._closed = True
        if self.pipelines is not None:
            self.pipelines.close()
        if self.collector is not None:
            self.collector.stop()
        if self._serving:
            # shutdown() blocks on the serve loop acknowledging — never
            # call it on a server whose serve_forever was never entered
            self._server.shutdown()
        self._server.server_close()
        if self._thread is not None:
            self._thread.join(timeout=5.0)
        self.reconciler.close()
        try:
            os.remove(self.discovery_path())
        except OSError:
            pass

    # -- tenancy -----------------------------------------------------------

    def _authenticate(self, header: Optional[str]) -> str:
        """Bearer token -> tenant name, or 401."""
        if header and header.startswith("Bearer "):
            tenant = self._tokens.get(header[len("Bearer ") :].strip())
            if tenant is not None:
                return tenant
        raise _DaemonError(401, "missing or invalid bearer token")

    def mint_session(self, tenant: str) -> str:
        """Issue a fresh bearer token bound to ``tenant`` (in-memory only;
        tokens die with the daemon)."""
        token = secrets.token_hex(16)
        with self._lock:
            self._tokens[token] = tenant
        return token

    def _active_jobs(self, tenant: str) -> int:
        """Jobs of the tenant whose last journaled state is still live.
        A job with no event yet counts as active (its SUBMITTED seed is
        written on the submit path, so this is a closing race, not a
        steady state)."""
        with self._lock:
            handles = [h for h, t in self._jobs.items() if t == tenant]
        active = 0
        for handle in handles:
            scheduler, app_id = self._split_handle(handle)
            event = self.reconciler.latest(scheduler, app_id) or self.store.latest(
                scheduler, app_id
            )
            if event is None or not (
                event.terminal or event.state == AppState.UNKNOWN
            ):
                active += 1
        obs_metrics.CONTROL_ACTIVE_JOBS.set(float(active), tenant=tenant)
        return active

    @staticmethod
    def _split_handle(handle: str) -> tuple[str, str]:
        from torchx_tpu_torch.specs.api import parse_app_handle

        scheduler, _, app_id = parse_app_handle(handle)
        return scheduler, app_id

    # -- verbs -------------------------------------------------------------

    def _op_session(self, tenant: str, req: dict) -> dict:
        if tenant != "root":
            raise _DaemonError(403, "only the root token mints sessions")
        name = str(req.get("tenant", "")).strip()
        if not name:
            raise _DaemonError(400, "missing tenant name")
        return {"token": self.mint_session(name)}

    def _parse_cfg(self, scheduler: str, req: dict) -> dict:
        # cfg_str (the CLI's raw -cfg string) parses against the
        # backend's typed runopts schema HERE — clients stay
        # schema-blind; an explicit cfg dict overlays the result
        cfg: dict = {}
        cfg_str = str(req.get("cfg_str") or "")
        if cfg_str:
            cfg.update(
                self.runner.scheduler_run_opts(scheduler).cfg_from_str(cfg_str)
            )
        cfg.update(dict(req.get("cfg") or {}))
        return cfg

    def _op_submit(self, tenant: str, req: dict) -> dict:
        component = req.get("component")
        scheduler = req.get("scheduler")
        if not component or not scheduler:
            raise _DaemonError(400, "submit needs component and scheduler")
        self._check_not_draining()
        if self.fleet is not None:
            return self._op_fleet_submit(tenant, req)
        active = self._active_jobs(tenant)
        if active >= self.tenant_cap:
            retry_after = settings.CONTROL_RETRY_AFTER_SECONDS
            raise _DaemonError(
                429,
                f"tenant {tenant!r} has {active} active jobs"
                f" (cap {self.tenant_cap}); retry after one finishes",
                payload={
                    "code": "tenant_cap_exceeded",
                    "tenant": tenant,
                    "active": active,
                    "cap": self.tenant_cap,
                    "retry_after_seconds": retry_after,
                },
                headers={"Retry-After": str(retry_after)},
            )
        try:
            cfg = self._parse_cfg(str(scheduler), req)
            handle = self.runner.run_component(
                str(component),
                [str(a) for a in req.get("args", [])],
                str(scheduler),
                cfg=cfg,
                workspace=req.get("workspace"),
            )
        except _DaemonError:
            raise
        except Exception as e:  # noqa: BLE001 - surfaced to the client
            raise _DaemonError(400, f"{type(e).__name__}: {e}") from e
        sched_name, app_id = self._split_handle(handle)
        with self._lock:
            self._jobs[handle] = tenant
        # seed the journal (the cap's ground truth) and join the watch
        # stream so the terminal event lands without anyone polling
        self.reconciler.ingest(
            StateEvent(
                scheduler=sched_name,
                app_id=app_id,
                state=AppState.SUBMITTED,
                source="daemon",
                cell=self.cell,
            )
        )
        self.reconciler.track(
            sched_name, self.runner._scheduler(sched_name), app_id
        )
        self._active_jobs(tenant)
        return {"handle": handle}

    def _op_fleet_submit(self, tenant: str, req: dict) -> dict:
        """Submit through the fleet scheduler: dryrun-validate, derive the
        gang demand from the materialized AppDef (overridable by explicit
        ``replicas``/``chips`` request fields), journal the resubmission
        recipe, and enqueue. 409 = the fleet can NEVER host the gang."""
        from torchx_tpu_torch.fleet.model import GangRequest
        from torchx_tpu_torch.specs.serialize import appdef_to_dict

        component = str(req.get("component"))
        scheduler = str(req.get("scheduler"))
        try:
            cfg = self._parse_cfg(scheduler, req)
            info = self.runner.dryrun_component(
                component,
                [str(a) for a in req.get("args", [])],
                scheduler,
                cfg=cfg,
                workspace=req.get("workspace"),
            )
        except Exception as e:  # noqa: BLE001 - surfaced to the client
            raise _DaemonError(400, f"{type(e).__name__}: {e}") from e
        app = info._app
        role = app.roles[0] if app.roles else None
        replicas = int(
            req.get("replicas")
            or (role.num_replicas if role is not None else 1)
        )
        chips = req.get("chips")
        if chips is None:
            gpu = role.resource.gpu if role is not None else None
            chips = gpu.gpus if gpu is not None else 1
        try:
            gang = GangRequest(
                job="",
                tenant=tenant,
                klass=str(req.get("priority") or "batch"),
                replicas=replicas,
                chips_per_replica=int(chips),
                elastic=bool(req.get("elastic")),
                mesh=str(req.get("mesh") or ""),
                min_replicas=int(req.get("min_replicas") or 1),
            )
        except ValueError as e:
            raise _DaemonError(400, str(e)) from e
        recipe = {
            "appdef": appdef_to_dict(app),
            "scheduler": scheduler,
            "cfg": cfg,
            "workspace": req.get("workspace"),
        }
        try:
            result = self.fleet.submit(gang, recipe)
        except NotImplementedError as e:
            # the placement oracle's seam (fleet/placer.py require_oracle):
            # a plan-shaped gang waits for the analyzer, ROADMAP item 2.8
            raise _DaemonError(
                501, str(e), payload={"code": "fleet_oracle_unported"}
            ) from e
        status = result.get("status")
        if status == "infeasible":
            raise _DaemonError(
                409,
                f"gang cannot fit this fleet: {result.get('reason')}",
                payload={"code": "fleet_infeasible", "fleet_job": result["job"]},
            )
        if status == "placed":
            return {"handle": result.get("handle", ""), "fleet_job": result["job"]}
        return {
            "queued": True,
            "fleet_job": result["job"],
            "position": result.get("position"),
            "class": result.get("class"),
        }

    def _op_queue(self, tenant: str, query: dict) -> dict:
        if self.fleet is None:
            return {"enabled": False}
        return self.fleet.queue_snapshot()

    def _status_payload(self, handle: str, status: Optional[Any]) -> dict:
        if status is None:
            return {"handle": handle, "state": "UNKNOWN", "terminal": True}
        failure_class = getattr(status, "failure_class", None)
        roles = []
        for role in getattr(status, "roles", []) or []:
            roles.append(
                {
                    "role": getattr(role, "role", ""),
                    "replicas": [
                        getattr(r, "id", 0)
                        for r in getattr(role, "replicas", []) or []
                    ],
                }
            )
        return {
            "handle": handle,
            "state": str(getattr(status.state, "name", status.state)),
            "terminal": bool(status.is_terminal()),
            "num_restarts": getattr(status, "num_restarts", 0),
            "msg": getattr(status, "msg", ""),
            "failure_class": (
                str(getattr(failure_class, "name", failure_class))
                if failure_class is not None
                else None
            ),
            "ui_url": getattr(status, "ui_url", None),
            "roles": roles,
        }

    def _op_status(self, tenant: str, query: dict) -> dict:
        handle = self._one(query, "handle")
        status = self.runner.status(handle)
        if status is None:
            raise _DaemonError(404, f"unknown app {handle}")
        return self._status_payload(handle, status)

    def _op_list(self, tenant: str, query: dict) -> dict:
        scheduler = query.get("scheduler", [None])[0]
        if scheduler:
            apps = self.runner.list(scheduler)
            return {
                "apps": [
                    {"app_id": a.app_id, "state": str(a.state.name)} for a in apps
                ]
            }
        # fleet view: everything the journal knows, no backend calls
        out = []
        for (sched, app_id), event in sorted(self.store.snapshot().items()):
            out.append(
                {
                    "scheduler": sched,
                    "app_id": app_id,
                    "state": event.state.name,
                    "time_usec": event.time_usec,
                }
            )
        return {"apps": out}

    def _op_cancel(self, tenant: str, req: dict) -> dict:
        handle = str(req.get("handle", ""))
        if not handle:
            # fleet job id: cancels a queued gang before it ever gets a
            # handle (or the current attempt of a running one)
            job = str(req.get("job", ""))
            if job and self.fleet is not None:
                if not self.fleet.cancel_job(job):
                    raise _DaemonError(404, f"unknown fleet job {job!r}")
                return {"ok": True}
            raise _DaemonError(400, "missing handle")
        try:
            self.runner.cancel(handle)
        except Exception as e:  # noqa: BLE001
            raise _DaemonError(400, f"{type(e).__name__}: {e}") from e
        return {"ok": True}

    def _op_wait(self, tenant: str, query: dict) -> dict:
        """Bounded long-poll: rides the reconciler's wake path, so a
        terminal event answers immediately; budget capped at 60s per
        request (clients re-issue — HTTP stays short-lived)."""
        handle = self._one(query, "handle")
        budget = min(60.0, float(query.get("timeout", ["30"])[0] or 30.0))
        scheduler, app_id = self._split_handle(handle)
        self.reconciler.track(
            scheduler, self.runner._scheduler(scheduler), app_id
        )
        deadline = self.clock() + budget
        while True:
            status = self.runner.status(handle)
            if status is None:
                return {"handle": handle, "state": "UNKNOWN", "terminal": True}
            if status.is_terminal():
                return self._status_payload(handle, status)
            remaining = deadline - self.clock()
            if remaining <= 0:
                payload = self._status_payload(handle, status)
                payload["terminal"] = False
                return payload
            self.reconciler.wait_event(
                scheduler, app_id, timeout=min(remaining, 2.0)
            )

    def _one(self, query: dict, key: str) -> str:
        vals = query.get(key) or []
        if not vals or not vals[0]:
            raise _DaemonError(400, f"missing query parameter {key!r}")
        return str(vals[0])

    # -- federation cell lifecycle -----------------------------------------

    def _inflight(self) -> int:
        """Jobs whose last journaled state is still live, across all
        tenants — the number a draining cell waits on before it counts
        as DRAINED."""
        with self._lock:
            handles = list(self._jobs)
        n = 0
        for handle in handles:
            scheduler, app_id = self._split_handle(handle)
            event = self.reconciler.latest(
                scheduler, app_id
            ) or self.store.latest(scheduler, app_id)
            if event is None or not (
                event.terminal or event.state == AppState.UNKNOWN
            ):
                n += 1
        return n

    def _cell_state(self) -> str:
        """The lifecycle label: DRAINING until in-flight work finishes,
        then DRAINED; HEALTHY when not draining."""
        if not self._draining:
            return "HEALTHY"
        return "DRAINING" if self._inflight() > 0 else "DRAINED"

    def cell_payload(self) -> dict:
        """The ``/v1/cell`` body: identity + lifecycle + rehydration."""
        state = self._cell_state()
        obs_metrics.FED_CELL_STATE.set(
            float(obs_metrics.CELL_STATE_VALUES.get(state, 0)),
            cell=self.cell,
        )
        return {
            "cell": self.cell,
            "state": state,
            "draining": self._draining,
            "inflight": self._inflight(),
            "rehydrated": self.rehydrated,
            "rehydration": dict(self.rehydration),
        }

    def _persist_cell(self) -> None:
        from torchx_tpu_torch.util.jsonl import rewrite_json

        rewrite_json(
            self._cell_path, {"cell": self.cell, "draining": self._draining}
        )

    def _check_not_draining(self) -> None:
        """503 new work away while draining. Deliberately NOT a 429: the
        client must not retry against this daemon — the federation
        router reads ``code: cell_draining`` and spills to another cell."""
        if self._draining:
            raise _DaemonError(
                503,
                f"cell {self.cell!r} is draining; submit elsewhere",
                payload={
                    "code": "cell_draining",
                    "cell": self.cell,
                    "state": self._cell_state(),
                },
                headers={
                    "Retry-After": str(settings.CONTROL_RETRY_AFTER_SECONDS)
                },
            )

    def _op_cell(self, tenant: str, query: dict) -> dict:
        return self.cell_payload()

    def _op_cell_drain(self, tenant: str, req: dict) -> dict:
        """Begin draining: durable flag first (journal-before-act), then
        refuse new submits. In-flight jobs keep running to terminal."""
        self._draining = True
        self._persist_cell()
        logger.info("cell %s draining (%d in flight)", self.cell, self._inflight())
        return self.cell_payload()

    def _op_cell_uncordon(self, tenant: str, req: dict) -> dict:
        """Reopen the cell; reports the transitional UNCORDONED label
        once (subsequent reads say HEALTHY)."""
        was_draining = self._draining
        self._draining = False
        self._persist_cell()
        payload = self.cell_payload()
        if was_draining:
            payload["state"] = "UNCORDONED"
        logger.info("cell %s uncordoned", self.cell)
        return payload

    # -- telemetry plane ---------------------------------------------------

    def _ingest_self(self) -> None:
        """Fold this process's own registry into the store (source
        ``control``) — collector hook AND pre-read refresh, so the
        aggregate never lags the daemon's own counters."""
        if self.telemetry_store is not None:
            self.telemetry_store.ingest_text(
                "control", obs_metrics.REGISTRY.render()
            )

    def _require_telemetry(self) -> Any:
        if self.telemetry_store is None:
            raise _DaemonError(
                501, "telemetry plane disabled on this daemon"
            )
        return self.telemetry_store

    def _op_metrics_query(self, tenant: str, query: dict) -> dict:
        """``/v1/metrics/query``: ``name`` (omit to list), ``reduce``
        (last/sum/avg/max/min/rate/pNN), ``range`` seconds, and
        ``label.K=V`` filters."""
        store = self._require_telemetry()
        self._ingest_self()
        names = query.get("name") or []
        if not names or not names[0]:
            return {"names": store.names()}
        labels = {
            k[len("label.") :]: vals[0]
            for k, vals in query.items()
            if k.startswith("label.") and vals
        }
        raw_range = query.get("range", [None])[0]
        try:
            range_s = float(raw_range) if raw_range else None
        except ValueError as e:
            raise _DaemonError(400, f"bad range: {raw_range!r}") from e
        reduce = query.get("reduce", [None])[0] or None
        try:
            return store.query(
                str(names[0]),
                labels=labels or None,
                reduce=reduce,
                range_s=range_s,
            )
        except ValueError as e:
            raise _DaemonError(400, str(e)) from e

    def _op_alerts(self, tenant: str, query: dict) -> dict:
        if self.slo_engine is None:
            return {"enabled": False, "alerts": [], "burns": {}}
        return {
            "enabled": True,
            "alerts": [a.to_json() for a in self.slo_engine.active()],
            "burns": {
                name: {"short": round(s, 3), "long": round(l, 3)}
                for name, (s, l) in sorted(self.slo_engine.burns().items())
            },
            "slos": [s.name for s in self.slo_engine.specs],
        }

    def _op_metrics_targets(self, tenant: str, req: dict) -> dict:
        """Register (``{"url", "name"?}``) or drop (``{"remove": name}``)
        a replica ``/metricz`` scrape target."""
        self._require_telemetry()
        assert self.collector is not None
        remove = str(req.get("remove") or "")
        if remove:
            if not self.collector.remove_target(remove):
                raise _DaemonError(404, f"unknown scrape target {remove!r}")
            return {"ok": True, "targets": self.collector.targets()}
        url = str(req.get("url") or "")
        if not url.startswith(("http://", "https://")):
            raise _DaemonError(400, f"scrape url must be http(s): {url!r}")
        name = req.get("name")
        source = self.collector.add_target(
            url, name=str(name) if name else None
        )
        return {"source": source, "targets": self.collector.targets()}

    # -- pipelines ---------------------------------------------------------

    def _op_pipeline_submit(self, tenant: str, req: dict) -> dict:
        """``POST /v1/pipelines``: validate the spec, journal, start."""
        from torchx_tpu_torch.pipelines.dag import PipelineSpec

        self._check_not_draining()
        doc = req.get("spec")
        if not isinstance(doc, dict):
            raise _DaemonError(400, "submit needs a 'spec' object")
        try:
            spec = PipelineSpec.from_dict(doc)
        except (ValueError, KeyError, TypeError) as e:
            raise _DaemonError(400, f"bad pipeline spec: {e}") from e
        try:
            pid = self.pipelines.submit(spec, tenant=tenant)
        except Exception as e:  # noqa: BLE001 - surfaced to the client
            raise _DaemonError(400, f"{type(e).__name__}: {e}") from e
        return {"pipeline": pid}

    def _op_pipeline_status(self, tenant: str, query: dict) -> dict:
        """``GET /v1/pipelines[?pipeline=]``: one record or the list."""
        pid = (query.get("pipeline") or [None])[0]
        try:
            return self.pipelines.status(str(pid) if pid else None)
        except KeyError as e:
            raise _DaemonError(404, str(e)) from e

    def _op_pipeline_cancel(self, tenant: str, req: dict) -> dict:
        """``POST /v1/pipelines/cancel``: cancel a pipeline's stages."""
        pid = str(req.get("pipeline", ""))
        if not pid:
            raise _DaemonError(400, "missing pipeline id")
        try:
            return self.pipelines.cancel(pid)
        except KeyError as e:
            raise _DaemonError(404, str(e)) from e

    def render_metricz(self) -> str:
        """The ``/metricz`` body: the cross-source fleet aggregate when
        the telemetry plane is up, else just this process's registry."""
        if self.telemetry_store is None:
            return obs_metrics.REGISTRY.render()
        self._ingest_self()
        return self.telemetry_store.render_prom()

    # -- HTTP plumbing -----------------------------------------------------

    def _make_handler(self) -> Any:
        daemon = self

        class Handler(BaseHTTPRequestHandler):
            def log_message(self, fmt: str, *args: Any) -> None:  # quiet
                pass

            def _reply(
                self,
                code: int,
                payload: dict,
                op: str = "",
                headers: Optional[dict] = None,
            ) -> None:
                body = json.dumps(payload).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                for name, value in (headers or {}).items():
                    self.send_header(name, str(value))
                self.end_headers()
                self.wfile.write(body)
                if op:
                    obs_metrics.CONTROL_REQUESTS.inc(op=op, code=str(code))

            def _run(self, op: str, fn: Any) -> None:
                start = time.perf_counter()
                headers: Optional[dict] = None
                try:
                    payload = fn()
                    code = 200
                except _DaemonError as e:
                    payload = {"error": e.message, **e.payload}
                    code, headers = e.code, e.headers
                except Exception as e:  # noqa: BLE001 - keep the daemon up
                    logger.warning("control %s failed: %s", op, e)
                    payload, code = {"error": f"{type(e).__name__}: {e}"}, 500
                obs_metrics.CONTROL_REQUEST_SECONDS.observe(
                    time.perf_counter() - start, op=op
                )
                self._reply(code, payload, op=op, headers=headers)

            def _tenant(self) -> str:
                return daemon._authenticate(self.headers.get("Authorization"))

            def _body(self) -> dict:
                n = int(self.headers.get("Content-Length", 0) or 0)
                raw = self.rfile.read(n) if n else b"{}"
                try:
                    doc = json.loads(raw or b"{}")
                except ValueError as e:
                    raise _DaemonError(400, f"bad JSON body: {e}") from e
                if not isinstance(doc, dict):
                    raise _DaemonError(400, "body must be a JSON object")
                return doc

            def do_GET(self) -> None:  # noqa: N802
                url = urlparse(self.path)
                query = parse_qs(url.query)
                if url.path == "/healthz":
                    self._reply(
                        200,
                        {
                            "status": (
                                "ok" if daemon.rehydrated else "rehydrating"
                            ),
                            "jobs": len(daemon.store),
                            "addr": daemon.addr,
                            "tenant_cap": daemon.tenant_cap,
                            "fleet": daemon.fleet is not None,
                            "cell": daemon.cell,
                            "draining": daemon._draining,
                            "rehydrated": daemon.rehydrated,
                            "rehydration": dict(daemon.rehydration),
                        },
                    )
                elif url.path == "/metricz":
                    text = daemon.render_metricz().encode()
                    self.send_response(200)
                    self.send_header(
                        "Content-Type", "text/plain; version=0.0.4"
                    )
                    self.send_header("Content-Length", str(len(text)))
                    self.end_headers()
                    self.wfile.write(text)
                elif url.path == "/v1/metrics/query":
                    self._run(
                        "metrics_query",
                        lambda: daemon._op_metrics_query(
                            self._tenant(), query
                        ),
                    )
                elif url.path == "/v1/alerts":
                    self._run(
                        "alerts",
                        lambda: daemon._op_alerts(self._tenant(), query),
                    )
                elif url.path == "/v1/status":
                    self._run(
                        "status",
                        lambda: daemon._op_status(self._tenant(), query),
                    )
                elif url.path == "/v1/list":
                    self._run(
                        "list", lambda: daemon._op_list(self._tenant(), query)
                    )
                elif url.path == "/v1/wait":
                    self._run(
                        "wait", lambda: daemon._op_wait(self._tenant(), query)
                    )
                elif url.path == "/v1/queue":
                    self._run(
                        "queue",
                        lambda: daemon._op_queue(self._tenant(), query),
                    )
                elif url.path == "/v1/pipelines":
                    self._run(
                        "pipeline_status",
                        lambda: daemon._op_pipeline_status(
                            self._tenant(), query
                        ),
                    )
                elif url.path == "/v1/cell":
                    self._run(
                        "cell", lambda: daemon._op_cell(self._tenant(), query)
                    )
                elif url.path == "/v1/logs":
                    self._logs(query)
                else:
                    self._reply(404, {"error": f"unknown path {url.path}"})

            def do_POST(self) -> None:  # noqa: N802
                url = urlparse(self.path)
                if url.path == "/v1/session":
                    self._run(
                        "session",
                        lambda: daemon._op_session(self._tenant(), self._body()),
                    )
                elif url.path == "/v1/submit":
                    self._run(
                        "submit",
                        lambda: daemon._op_submit(self._tenant(), self._body()),
                    )
                elif url.path == "/v1/cancel":
                    self._run(
                        "cancel",
                        lambda: daemon._op_cancel(self._tenant(), self._body()),
                    )
                elif url.path == "/v1/metrics/targets":
                    self._run(
                        "metrics_targets",
                        lambda: daemon._op_metrics_targets(
                            self._tenant(), self._body()
                        ),
                    )
                elif url.path == "/v1/pipelines":
                    self._run(
                        "pipeline_submit",
                        lambda: daemon._op_pipeline_submit(
                            self._tenant(), self._body()
                        ),
                    )
                elif url.path == "/v1/pipelines/cancel":
                    self._run(
                        "pipeline_cancel",
                        lambda: daemon._op_pipeline_cancel(
                            self._tenant(), self._body()
                        ),
                    )
                elif url.path == "/v1/cell/drain":
                    self._run(
                        "cell_drain",
                        lambda: daemon._op_cell_drain(
                            self._tenant(), self._body()
                        ),
                    )
                elif url.path == "/v1/cell/uncordon":
                    self._run(
                        "cell_uncordon",
                        lambda: daemon._op_cell_uncordon(
                            self._tenant(), self._body()
                        ),
                    )
                else:
                    self._reply(404, {"error": f"unknown path {url.path}"})

            def _logs(self, query: dict) -> None:
                """Log attach: JSONL stream, one {"line": ...} per log
                line, closed by {"done": true}. Auth + argument errors
                surface as clean JSON replies BEFORE streaming starts."""
                try:
                    self._tenant()
                    handle = daemon._one(query, "handle")
                    role = query.get("role", ["app"])[0]
                    k = int(query.get("k", ["0"])[0] or 0)
                    tail = query.get("tail", ["0"])[0] in ("1", "true")
                    lines = daemon.runner.log_lines(
                        handle, role, k=k, should_tail=tail
                    )
                except _DaemonError as e:
                    self._reply(e.code, {"error": e.message}, op="logs")
                    return
                except Exception as e:  # noqa: BLE001
                    self._reply(
                        400, {"error": f"{type(e).__name__}: {e}"}, op="logs"
                    )
                    return
                obs_metrics.CONTROL_REQUESTS.inc(op="logs", code="200")
                self.send_response(200)
                self.send_header("Content-Type", "application/jsonl")
                self.send_header("Connection", "close")
                self.end_headers()
                try:
                    for line in lines:
                        self.wfile.write(
                            json.dumps({"line": line.rstrip("\n")}).encode()
                            + b"\n"
                        )
                        self.wfile.flush()
                    self.wfile.write(b'{"done": true}\n')
                except (BrokenPipeError, ConnectionResetError):
                    pass  # client detached mid-stream

        return Handler
