from torchx_tpu_torch.runner.api import Runner, get_runner  # noqa: F401
