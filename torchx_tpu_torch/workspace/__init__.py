from torchx_tpu_torch.workspace.api import WorkspaceMixin, walk_workspace  # noqa: F401
