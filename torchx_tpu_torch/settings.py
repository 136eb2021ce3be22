"""Every environment variable and default the launcher reads or writes,
copied from :mod:`torchx_tpu.settings` with the same values: either
launcher injects these variables and reads these files, so a job launched
by one is read by the other.

Variables fall into two groups:

* client-side knobs read by the runner and the CLI,
* in-job variables injected by schedulers into every replica.

The TPU runtime variables of the JAX package are a TPU assumption and are
not copied; the three GPU names that take their place are the port's own
(see the end of this file).
"""

# ---------------------------------------------------------------------------
# Client side
# ---------------------------------------------------------------------------

# Points at an explicit config file, overriding the lookup chain
# (CLI > $TPXCONFIG > $HOME/.tpxconfig > CWD).
ENV_TPXCONFIG = "TPXCONFIG"

# Comma list of extra named-resource modules to load (module[:fn] specs).
# See specs/__init__.py.
ENV_TPX_CUSTOM_NAMED_RESOURCES = "TPX_CUSTOM_NAMED_RESOURCES"

# Bitmask controlling which plugin sources are consulted (see plugins/).
ENV_TPX_PLUGINS_SOURCE = "TPX_PLUGINS_SOURCE"

# Propagates the client session id into subprocesses, so a client and the
# replicas it launches write into one observability session directory.
ENV_TPX_INTERNAL_SESSION_ID = "TPX_INTERNAL_SESSION_ID"

# Scheduler params harvested by the runner from the environment, e.g.
# TPX_PARAMS_LOG_DIR=...
ENV_TPX_PARAMS_PREFIX = "TPX_PARAMS_"

# Telemetry destination for the events logger ("null"/"console"/"log"/
# "jsonl"/...).
ENV_TPX_EVENT_DESTINATION = "TPX_EVENT_DESTINATION"

# Tracing master switch: "0"/"false"/"off" disables span emission.
ENV_TPX_TRACE = "TPX_TRACE"

# Root directory for durable observability output; defaults to
# ~/.torchx_tpu/obs (one subdirectory per session). See obs/sinks.py.
ENV_TPX_OBS_DIR = "TPX_OBS_DIR"

# Step-profiler master switch: "1"/"true"/"yes"/"on" enables the trainer's
# per-step phase attribution (equivalent to its ``--profile`` flag),
# appending profile.jsonl under the obs session dir. See obs/profile.py.
ENV_TPX_PROFILE = "TPX_PROFILE"

# Escape hatch for the preflight analyzer gate: "1"/"true"/"yes"/"on" skips
# linting entirely (same effect as the ``--no-lint`` CLI flag).
ENV_TPX_NO_LINT = "TPX_NO_LINT"

# Per-call deadline (seconds) for control-plane subprocesses (gcloud /
# kubectl / sbatch / squeue ...). Unset = DEFAULT_CONTROL_PLANE_TIMEOUT;
# "0"/"off"/"none" disables the deadline entirely.
ENV_TPX_CONTROL_PLANE_TIMEOUT = "TPX_CONTROL_PLANE_TIMEOUT"
DEFAULT_CONTROL_PLANE_TIMEOUT = 60.0

# Deterministic control-plane fault plan (inline JSON or a path to a JSON
# file): inject transient / permanent / timeout / garbage-stdout failures on
# the Nth matching call, per backend+op.
ENV_TPX_FAULT_PLAN = "TPX_FAULT_PLAN"

# Root directory for durable supervisor session state (attempt ledger +
# resume metadata); defaults to ~/.torchx_tpu/supervisor.
ENV_TPX_SUPERVISOR_DIR = "TPX_SUPERVISOR_DIR"

# TTL (seconds) for the runner's describe cache; "0" disables caching for
# non-terminal states. Shorter than any poll interval the runner uses, so
# back-to-back polls coalesce but successive wait ticks see fresh state.
ENV_TPX_DESCRIBE_CACHE_TTL = "TPX_DESCRIBE_CACHE_TTL"
DEFAULT_DESCRIBE_CACHE_TTL = 1.0

# State root for the config autotuner (`tpx tune`). Default
# ~/.torchx_tpu/tune.
ENV_TPX_TUNE_DIR = "TPX_TUNE_DIR"

# Device count assumed by `tpx tune` when --devices is not passed.
ENV_TPX_TUNE_DEVICES = "TPX_TUNE_DEVICES"

# Path to a tune plan artifact pinned for submission: the submit gate diffs
# every plan-shaped role against it. Unset = no pinning.
ENV_TPX_PLAN_ARTIFACT = "TPX_PLAN_ARTIFACT"

# Address ("host:port") of a running `tpx control` daemon; set, the CLI
# proxies submit/status/list/cancel/log through the daemon's HTTP API.
ENV_TPX_CONTROL_ADDR = "TPX_CONTROL_ADDR"

# Bearer token presented to the control daemon. Falls back to the token
# recorded in the daemon's discovery file ($TPX_CONTROL_DIR/control.json).
ENV_TPX_CONTROL_TOKEN = "TPX_CONTROL_TOKEN"

# State root for the control plane. Default ~/.torchx_tpu/control.
ENV_TPX_CONTROL_DIR = "TPX_CONTROL_DIR"

# Minimum interval (seconds) between full-registry metrics textfile
# re-renders by the prom event handler (obs/sinks.py); events arriving
# inside the window mark the registry dirty and a final flush on handler
# close writes them. "0" restores flush-on-every-event.
ENV_TPX_METRICS_MIN_INTERVAL = "TPX_METRICS_MIN_INTERVAL"
DEFAULT_METRICS_MIN_INTERVAL = 2.0

# Scrape/ingest interval (seconds) of the control daemon's telemetry
# collector, and its per-series ring-buffer capacity (720 samples: one hour
# at the default interval).
ENV_TPX_TELEMETRY_INTERVAL = "TPX_TELEMETRY_INTERVAL"
DEFAULT_TELEMETRY_INTERVAL = 5.0
DEFAULT_TELEMETRY_CAPACITY = 720

# Poll interval (seconds) for watch adapters that fall back to polling and
# for the local scheduler's sidecar mtime watcher.
ENV_TPX_WATCH_INTERVAL = "TPX_WATCH_INTERVAL"
DEFAULT_WATCH_INTERVAL = 1.0

# Default per-tenant cap on concurrently active jobs submitted through the
# control daemon; submits past the cap get HTTP 429.
DEFAULT_CONTROL_TENANT_CAP = 64

# Seconds a 429'd client should wait before resubmitting, how many times
# the client sleeps out a Retry-After and retries, and the ceiling on one
# such sleep.
CONTROL_RETRY_AFTER_SECONDS = 5
CONTROL_429_MAX_RETRIES = 3
CONTROL_429_RETRY_CAP_SECONDS = 30.0

# This control daemon's cell name within a federation. Unset = "default".
ENV_TPX_CELL = "TPX_CELL"
DEFAULT_CELL_NAME = "default"

# State root of the federation layer (cells.jsonl). Default
# ~/.torchx_tpu/federation.
ENV_TPX_FEDERATION_DIR = "TPX_FEDERATION_DIR"

# Long-window SLO burn rate at/above which the federation router spills new
# traffic to the next-best cell.
DEFAULT_FEDERATION_BURN_BUDGET = 1.0

# Per-cell circuit breaker of the federation router: consecutive transport
# failures before the cell is skipped, and how long it sits out.
FEDERATION_BREAKER_TRIP_AFTER = 3
FEDERATION_BREAKER_COOLDOWN_SECONDS = 5.0

# ---------------------------------------------------------------------------
# In-job (injected by schedulers into every replica)
# ---------------------------------------------------------------------------

# App handle / id of the surrounding job: set means "launched by tpx".
ENV_TPX_APP_ID = "TPX_APP_ID"
ENV_TPX_JOB_ID = "TPX_JOB_ID"  # full handle scheme://session/app_id

# Replica identity within the role's gang (the global process id), the
# role's name and the number of replicas in the gang.
ENV_TPX_REPLICA_ID = "TPX_REPLICA_ID"
ENV_TPX_ROLE_NAME = "TPX_ROLE_NAME"
ENV_TPX_NUM_REPLICAS = "TPX_NUM_REPLICAS"

# Multi-slice decomposition of the global replica id, injected by backends
# that cannot do arithmetic at pod start:
# ``replica_id = slice_id * hosts_per_slice + host_id``.
ENV_TPX_SLICE_ID = "TPX_SLICE_ID"
ENV_TPX_HOST_ID = "TPX_HOST_ID"
ENV_TPX_HOSTS_PER_SLICE = "TPX_HOSTS_PER_SLICE"

# Fault-injection hook of the example apps (examples/compute_mesh_size):
# "1" always throws, "once:/path/marker" throws only on the first attempt;
# _REPLICA scopes the fault to one replica of the gang.
ENV_TPX_EXAMPLE_THROWS = "TPX_EXAMPLE_THROWS"
ENV_TPX_EXAMPLE_THROWS_REPLICA = "TPX_EXAMPLE_THROWS_REPLICA"

# Elastic lower bound of the gang (replicas may legally shrink to this on
# restart after host loss).
ENV_TPX_MIN_REPLICAS = "TPX_MIN_REPLICAS"

# Host of replica 0: the rendezvous store of the process group lives there.
# The *name* of this variable is what ``specs.macros.coordinator_env``
# substitutes.
ENV_TPX_COORDINATOR_HOST = "TPX_COORDINATOR_HOST"

# Default rendezvous port (the launcher's coordinator port).
TPX_COORDINATOR_PORT = 8476

# File each replica writes a structured error JSON into on failure.
ENV_TPX_ERROR_FILE = "TPX_ERROR_FILE"

# Per-replica log directory.
ENV_TPX_LOG_DIR = "TPX_LOG_DIR"

# Trace correlation: the client injects these at submit, so in-job spans
# (the trainer's launch spans and heartbeats) join the client's trace.
ENV_TPX_TRACE_ID = "TPX_TRACE_ID"
ENV_TPX_PARENT_SPAN = "TPX_PARENT_SPAN"

# Checkpoint step a resubmitted (supervised) run should resume from; the
# supervisor injects it from the checkpoint manifest.
ENV_TPX_RESUME_STEP = "TPX_RESUME_STEP"

# Mesh spec override (``--mesh`` syntax) that an elastic reshape injects;
# the trainer honours it over its ``--mesh`` flag.
ENV_TPX_MESH = "TPX_MESH"

# Injected by the fleet scheduler into every replica it places: the fleet
# job id and the gang's priority class.
ENV_TPX_FLEET_JOB = "TPX_FLEET_JOB"
ENV_TPX_FLEET_CLASS = "TPX_FLEET_CLASS"

# Preemption drill knob for the local scheduler only: a replica exiting
# with this code marks the attempt PREEMPTED instead of FAILED.
ENV_TPX_SIMULATE_PREEMPTION_EXIT = "TPX_SIMULATE_PREEMPTION_EXIT"

# Manifest file the Checkpointer keeps next to its step directories: the
# latest finalized step and each step's content digest, read by the
# client-side supervisor and the eval gate without importing the trainer.
CHECKPOINT_MANIFEST = "MANIFEST.json"

# Experiment tracking: the trackers to load, TPX_TRACKER_<NAME>_CONFIG, and
# the parent run a job's run links to.
ENV_TPX_TRACKERS = "TPX_TRACKERS"
ENV_TPX_TRACKER_PREFIX = "TPX_TRACKER_"
ENV_TPX_PARENT_RUN_ID = "TPX_PARENT_RUN_ID"

# RMSNorm backward selection when the call site says "auto" (ops/norms.py).
ENV_TPX_FUSED_NORM = "TPX_FUSED_NORM"

# ---------------------------------------------------------------------------
# TPU assumptions, not copied
# ---------------------------------------------------------------------------
# The JAX package also names the TPU and XLA runtime variables: the GKE TPU
# host list (TPU_WORKER_ID, TPU_WORKER_HOSTNAMES, TPU_SKIP_MDS_QUERY), the
# host-local chip partitioning (TPU_VISIBLE_CHIPS, TPU_PROCESS_BOUNDS,
# TPU_CHIPS_PER_PROCESS_BOUNDS), the CPU simulation (JAX_PLATFORMS,
# XLA_FLAGS) and the multi-slice DCN wiring (MEGASCALE_COORDINATOR_ADDRESS,
# MEGASCALE_NUM_SLICES, MEGASCALE_SLICE_ID). None of them means anything to
# a CUDA job. Their GPU counterparts follow.

# ---------------------------------------------------------------------------
# GPU assumptions, the port's own
# ---------------------------------------------------------------------------
# The cards a replica sees: the local scheduler gives each replica its
# role's share of the host's cards (schedulers/local_scheduler.py
# gpu_device_env), and counts the host's cards from it when the launcher's
# own environment sets it.
ENV_CUDA_VISIBLE_DEVICES = "CUDA_VISIBLE_DEVICES"
# A GPU role's slice as every replica's environment names it: the
# accelerator type ("h100-16") and the topology, hosts x cards a host ("2x8").
ENV_TPX_GPU_ACCELERATOR_TYPE = "TPX_GPU_ACCELERATOR_TYPE"
ENV_TPX_GPU_TOPOLOGY = "TPX_GPU_TOPOLOGY"
# The slice count of a multi-slice GPU role on GKE (``num_replicas`` > 1):
# the value ``macros.num_replicas`` expands to in the pod template, and the
# one a resize rewrites beside ``TPX_NUM_REPLICAS``.
ENV_TPX_NUM_SLICES = "TPX_NUM_SLICES"
