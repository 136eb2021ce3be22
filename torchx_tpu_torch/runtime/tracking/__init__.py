from torchx_tpu_torch.runtime.tracking.api import (  # noqa: F401
    FsspecResultTracker,
    ResultTracker,
)
