"""AppDef <-> plain-dict (JSON) serialization: the port of
:mod:`torchx_tpu.specs.serialize`.

Powers ``tpx run --stdin`` (reference analog: JSON job-spec mode,
cli/cmd_run.py:366-399) and programmatic job submission from non-Python
clients: an AppDef round-trips through a stable JSON shape. The shape is
the JAX package's with one key changed: a resource's accelerator is
``"gpu": {"accelerator", "gpus"}`` where the JAX package writes ``"tpu"``.
Either package reads the other's spec of a CPU-only app (the JAX
package's ``"tpu": null`` carries nothing); a spec that asks for a TPU slice
is refused here, never run without its accelerator.

Also home of the supervisor policy's round trip backing ``tpx-torch
supervise --policy policy.json``.
"""

from __future__ import annotations

from typing import Any, Mapping

from torchx_tpu_torch.specs.api import (
    AppDef,
    BindMount,
    DeviceMount,
    Resource,
    RetryPolicy,
    GpuSlice,
    Role,
    VolumeMount,
    Workspace,
)


def appdef_to_dict(app: AppDef) -> dict[str, Any]:
    return {
        "name": app.name,
        "metadata": dict(app.metadata),
        "roles": [
            {
                "name": r.name,
                "image": r.image,
                "entrypoint": r.entrypoint,
                "args": list(r.args),
                "env": dict(r.env),
                "num_replicas": r.num_replicas,
                "min_replicas": r.min_replicas,
                "max_retries": r.max_retries,
                "retry_policy": r.retry_policy.value,
                "port_map": dict(r.port_map),
                "metadata": dict(r.metadata),
                "resource": {
                    "cpu": r.resource.cpu,
                    "memMB": r.resource.memMB,
                    "gpu": (
                        {
                            "accelerator": r.resource.gpu.accelerator,
                            "gpus": r.resource.gpu.gpus,
                        }
                        if r.resource.gpu
                        else None
                    ),
                    "capabilities": dict(r.resource.capabilities),
                    "devices": dict(r.resource.devices),
                    "tags": dict(r.resource.tags),
                },
                "mounts": [_mount_to_dict(m) for m in r.mounts],
                "workspace": (
                    dict(r.workspace.projects) if r.workspace else None
                ),
            }
            for r in app.roles
        ],
    }


def _mount_to_dict(m: Any) -> dict[str, Any]:
    if isinstance(m, BindMount):
        return {"type": "bind", "src": m.src_path, "dst": m.dst_path, "read_only": m.read_only}
    if isinstance(m, VolumeMount):
        return {"type": "volume", "src": m.src, "dst": m.dst_path, "read_only": m.read_only}
    if isinstance(m, DeviceMount):
        return {"type": "device", "src": m.src_path, "dst": m.dst_path, "permissions": m.permissions}
    raise ValueError(f"unknown mount type: {m!r}")


def _mount_from_dict(d: Mapping[str, Any]) -> Any:
    t = d.get("type")
    if t == "bind":
        return BindMount(src_path=d["src"], dst_path=d["dst"], read_only=bool(d.get("read_only")))
    if t == "volume":
        return VolumeMount(src=d["src"], dst_path=d["dst"], read_only=bool(d.get("read_only")))
    if t == "device":
        return DeviceMount(src_path=d["src"], dst_path=d.get("dst", d["src"]), permissions=d.get("permissions", "rwm"))
    raise ValueError(f"unknown mount type in {d!r}")


def appdef_from_dict(data: Mapping[str, Any]) -> AppDef:
    roles = []
    for rd in data.get("roles", []):
        res = rd.get("resource") or {}
        if res.get("tpu"):
            raise ValueError(
                f"role {rd.get('name')!r} asks for a TPU slice ('tpu':"
                f" {res['tpu']!r}); this launcher runs GPU slices: give"
                " 'gpu': {'accelerator': 'h100', 'gpus': N}"
            )
        gpu_d = res.get("gpu")
        resource = Resource(
            cpu=res.get("cpu", -1),
            memMB=res.get("memMB", -1),
            gpu=(
                GpuSlice(accelerator=gpu_d["accelerator"], gpus=int(gpu_d["gpus"]))
                if gpu_d
                else None
            ),
            capabilities=dict(res.get("capabilities") or {}),
            devices=dict(res.get("devices") or {}),
            tags=dict(res.get("tags") or {}),
        )
        roles.append(
            Role(
                name=rd["name"],
                image=rd.get("image", ""),
                entrypoint=rd.get("entrypoint", ""),
                args=list(rd.get("args") or []),
                env=dict(rd.get("env") or {}),
                num_replicas=int(rd.get("num_replicas", 1)),
                min_replicas=rd.get("min_replicas"),
                max_retries=int(rd.get("max_retries", 0)),
                retry_policy=RetryPolicy(rd.get("retry_policy", "APPLICATION")),
                port_map={k: int(v) for k, v in (rd.get("port_map") or {}).items()},
                metadata=dict(rd.get("metadata") or {}),
                resource=resource,
                mounts=[_mount_from_dict(m) for m in (rd.get("mounts") or [])],
                workspace=(
                    Workspace(projects=dict(rd["workspace"]))
                    if rd.get("workspace")
                    else None
                ),
            )
        )
    if not roles:
        raise ValueError("job spec has no roles")
    return AppDef(
        name=data.get("name", "app"),
        roles=roles,
        metadata=dict(data.get("metadata") or {}),
    )


# =========================================================================
# SupervisorPolicy <-> dict (supervisor imported lazily: specs is the
# foundation layer and must not depend on the supervisor at import time)
# =========================================================================


def supervisor_policy_to_dict(policy: Any) -> dict[str, Any]:
    """-> a JSON-safe dict of every :class:`SupervisorPolicy` field."""
    from dataclasses import asdict

    return asdict(policy)


def supervisor_policy_from_dict(data: Mapping[str, Any]) -> Any:
    """Build a :class:`SupervisorPolicy` from a (possibly partial) dict;
    unknown keys raise so a typo'd policy file fails loudly instead of
    silently running with defaults."""
    from dataclasses import fields

    from torchx_tpu_torch.supervisor.policy import SupervisorPolicy

    known = {f.name for f in fields(SupervisorPolicy)}
    unknown = set(data) - known
    if unknown:
        raise ValueError(
            f"unknown supervisor policy keys {sorted(unknown)};"
            f" valid keys: {sorted(known)}"
        )
    return SupervisorPolicy(**dict(data))
