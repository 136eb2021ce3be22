"""Utility components: the port of :mod:`torchx_tpu.components.utils`
(reference analog: torchx/components/utils.py).

These are deliberately trivial AppDef factories used for smoke tests,
examples, and as scaffolding in pipelines (sh glue steps, file touch
barriers, data copies).
"""

from __future__ import annotations

import shlex
from typing import Optional

import torchx_tpu_torch.specs as specs
from torchx_tpu_torch.version import TORCHX_TPU_IMAGE


def echo(
    msg: str = "hello world", image: str = TORCHX_TPU_IMAGE, num_replicas: int = 1
) -> specs.AppDef:
    """Echos a message to stdout (for testing).

    Args:
        msg: message to echo
        image: image to use
        num_replicas: number of replicas to run
    """
    return specs.AppDef(
        name="echo",
        roles=[
            specs.Role(
                name="echo",
                image=image,
                entrypoint="echo",
                args=[msg],
                num_replicas=num_replicas,
                resource=specs.Resource(cpu=1, memMB=1024),
            )
        ],
    )


def touch(file: str, image: str = TORCHX_TPU_IMAGE) -> specs.AppDef:
    """Touches a file (for testing and as a pipeline barrier).

    Args:
        file: file to create
        image: image to use
    """
    return specs.AppDef(
        name="touch",
        roles=[
            specs.Role(
                name="touch",
                image=image,
                entrypoint="touch",
                args=[file],
                resource=specs.Resource(cpu=1, memMB=1024),
            )
        ],
    )


def sh(
    *args: str,
    image: str = TORCHX_TPU_IMAGE,
    num_replicas: int = 1,
    cpu: int = 1,
    memMB: int = 1024,
    h: Optional[str] = None,
    env: Optional[dict[str, str]] = None,
    max_retries: int = 0,
    mounts: Optional[list[str]] = None,
) -> specs.AppDef:
    """Runs the provided command via sh.

    Args:
        args: bash arguments (will be quoted)
        image: image to use
        num_replicas: number of replicas to run
        cpu: cpu count per replica
        memMB: RAM per replica in MB
        h: named resource (overrides cpu/memMB)
        env: environment variables
        max_retries: number of retries allowed
        mounts: mounts to add, docker-style string form
    """
    escaped = " ".join(shlex.quote(a) for a in args)
    return specs.AppDef(
        name="sh",
        roles=[
            specs.Role(
                name="sh",
                image=image,
                entrypoint="sh",
                args=["-c", escaped],
                num_replicas=num_replicas,
                env=env or {},
                max_retries=max_retries,
                resource=specs.resource(cpu=cpu, memMB=memMB, h=h),
                mounts=specs.parse_mounts(mounts) if mounts else [],
            )
        ],
    )


def python(
    *args: str,
    m: Optional[str] = None,
    c: Optional[str] = None,
    script: Optional[str] = None,
    image: str = TORCHX_TPU_IMAGE,
    name: str = "python",
    cpu: int = 1,
    memMB: int = 1024,
    h: Optional[str] = None,
    num_replicas: int = 1,
    env: Optional[dict[str, str]] = None,
) -> specs.AppDef:
    """Runs python with the specified module, command or script on the local
    image.

    Args:
        args: arguments passed to the program
        m: run a module as __main__
        c: program passed as string
        script: python script to run
        image: image to use
        name: name of the job
        cpu: cpu count per replica
        memMB: RAM per replica in MB
        h: named resource (overrides cpu/memMB)
        num_replicas: number of replicas
        env: environment variables
    """
    chosen = [x for x in (m, c, script) if x is not None]
    if len(chosen) != 1:
        raise ValueError("exactly one of --m, --c, --script must be set")
    if m is not None:
        prog_args = ["-m", m, *args]
    elif c is not None:
        prog_args = ["-c", c, *args]
    else:
        prog_args = [str(script), *args]
    return specs.AppDef(
        name=name,
        roles=[
            specs.Role(
                name=name,
                image=image,
                entrypoint="python",
                args=["-u", *prog_args],
                num_replicas=num_replicas,
                env=env or {},
                resource=specs.resource(cpu=cpu, memMB=memMB, h=h),
            )
        ],
    )


def copy(src: str, dst: str, image: str = TORCHX_TPU_IMAGE) -> specs.AppDef:
    """Copies the provided file or directory (fsspec URLs supported).

    Args:
        src: source path or url
        dst: destination path or url
        image: image to use
    """
    return specs.AppDef(
        name="copy",
        roles=[
            specs.Role(
                name="copy",
                image=image,
                entrypoint="python",
                args=["-m", "torchx_tpu_torch.apps.copy_main", "--src", src, "--dst", dst],
                resource=specs.Resource(cpu=1, memMB=1024),
            )
        ],
    )


def booth(
    x1: float,
    x2: float,
    image: str = TORCHX_TPU_IMAGE,
) -> specs.AppDef:
    """Evaluates the booth function at (x1, x2) and tracks the result
    (test objective for tracker/hpo integration).

    Args:
        x1: x1 coordinate
        x2: x2 coordinate
        image: image to use
    """
    return specs.AppDef(
        name="booth",
        roles=[
            specs.Role(
                name="booth",
                image=image,
                entrypoint="python",
                args=["-m", "torchx_tpu_torch.apps.booth_main", "--x1", str(x1), "--x2", str(x2)],
                resource=specs.Resource(cpu=1, memMB=1024),
            )
        ],
    )
