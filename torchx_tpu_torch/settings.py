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
