"""The names the port shares with the launcher, copied from
:mod:`torchx_tpu.settings` (the values must stay identical: the launcher
injects these variables and reads these files)."""

# Propagates the client session id into subprocesses, so a client and the
# replicas it launches write into one observability session directory.
ENV_TPX_INTERNAL_SESSION_ID = "TPX_INTERNAL_SESSION_ID"

# Tracing master switch: "0"/"false"/"off" disables span emission.
ENV_TPX_TRACE = "TPX_TRACE"

# Root directory for durable observability output; defaults to
# ~/.torchx_tpu/obs (one subdirectory per session). See obs/sinks.py.
ENV_TPX_OBS_DIR = "TPX_OBS_DIR"

# Replica identity within the role's gang (the global process id).
ENV_TPX_REPLICA_ID = "TPX_REPLICA_ID"

# Trace correlation: the client injects these at submit, so in-job spans
# (the trainer's launch spans and heartbeats) join the client's trace.
ENV_TPX_TRACE_ID = "TPX_TRACE_ID"
ENV_TPX_PARENT_SPAN = "TPX_PARENT_SPAN"

# Checkpoint step a resubmitted (supervised) run should resume from; the
# supervisor injects it from the checkpoint manifest.
ENV_TPX_RESUME_STEP = "TPX_RESUME_STEP"

# Manifest file the Checkpointer keeps next to its step directories: the
# latest finalized step and each step's content digest, read by the
# client-side supervisor and the eval gate without importing the trainer.
CHECKPOINT_MANIFEST = "MANIFEST.json"

# Step-profiler master switch: "1"/"true"/"yes"/"on" enables the trainer's
# per-step phase attribution (equivalent to its ``--profile`` flag),
# appending profile.jsonl under the obs session dir. See obs/profile.py.
ENV_TPX_PROFILE = "TPX_PROFILE"

# Minimum interval (seconds) between full-registry metrics textfile
# re-renders by the prom event handler (obs/sinks.py); events arriving
# inside the window mark the registry dirty and a final flush on handler
# close writes them. "0" restores flush-on-every-event.
ENV_TPX_METRICS_MIN_INTERVAL = "TPX_METRICS_MIN_INTERVAL"
DEFAULT_METRICS_MIN_INTERVAL = 2.0

# -- the gang (apps/spmd_main.py, distributed/) ------------------------------
# The launcher injects these into every replica of a role. The GKE TPU
# fallbacks of the JAX package (TPU_WORKER_ID, TPU_WORKER_HOSTNAMES) are a
# TPU assumption and are not read here.

# App handle / id of the surrounding job: set means "launched by tpx".
ENV_TPX_APP_ID = "TPX_APP_ID"

# Number of replicas in the role's gang.
ENV_TPX_NUM_REPLICAS = "TPX_NUM_REPLICAS"

# Multi-slice decomposition of the global replica id, injected by backends
# that cannot do arithmetic at pod start:
# ``replica_id = slice_id * hosts_per_slice + host_id``.
ENV_TPX_SLICE_ID = "TPX_SLICE_ID"
ENV_TPX_HOST_ID = "TPX_HOST_ID"
ENV_TPX_HOSTS_PER_SLICE = "TPX_HOSTS_PER_SLICE"

# Host of replica 0: the rendezvous store of the process group lives there.
ENV_TPX_COORDINATOR_HOST = "TPX_COORDINATOR_HOST"

# Default rendezvous port (the launcher's coordinator port).
TPX_COORDINATOR_PORT = 8476

# File each replica writes a structured error JSON into on failure.
ENV_TPX_ERROR_FILE = "TPX_ERROR_FILE"

# Mesh spec override (``--mesh`` syntax) that an elastic reshape injects;
# the trainer honours it over its ``--mesh`` flag.
ENV_TPX_MESH = "TPX_MESH"

# Fault-injection hook of the example apps (examples/compute_mesh_size):
# "1" always throws, "once:/path/marker" throws only on the first attempt;
# _REPLICA scopes the fault to one replica of the gang.
ENV_TPX_EXAMPLE_THROWS = "TPX_EXAMPLE_THROWS"
ENV_TPX_EXAMPLE_THROWS_REPLICA = "TPX_EXAMPLE_THROWS_REPLICA"
