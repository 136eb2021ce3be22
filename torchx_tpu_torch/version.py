"""Version of the torchx_tpu_torch package.

The version string is the JAX package's: it keys the workspace image's
content digest (``workspace/docker_workspace.py``), so a workspace builds to
the same digest from either launcher.
"""

__version__ = "0.1.0"

# The image used by components when none is given: the port's image (PyTorch
# with CUDA). For the local scheduler the image is a directory; remote
# schedulers expect a container image tag.
TORCHX_TPU_IMAGE = f"ghcr.io/torchx-tpu/torchx-tpu-torch:{__version__}"
