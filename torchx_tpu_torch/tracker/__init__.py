from torchx_tpu_torch.tracker.api import AppRun, TrackerBase, trackers_from_environ  # noqa: F401


def app_run_from_env() -> AppRun:
    """Convenience alias (reference: torchx.tracker.app_run_from_env)."""
    return AppRun.run_from_env()
