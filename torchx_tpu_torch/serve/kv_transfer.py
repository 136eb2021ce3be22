"""KV-block transfer seam between prefill and decode replicas.

The port's copy of :mod:`torchx_tpu.serve.kv_transfer` (numpy only);
only its imports differ. The port's engine uses :class:`KvPayload`,
:func:`new_request_id` and :class:`TransferRejected`; the transports
serve the disaggregated roles, which the port's server does not run yet.

Disaggregated serving splits the two phases of generation onto dedicated
replica gangs: prefill replicas (compute-bound, prefix-cache-warm) build
the KV state for a prompt, then *stream the computed blocks* to a decode
replica (HBM-bandwidth-bound) that carries the sequence to completion.
This module is the transport seam: a :class:`KvPayload` (tokens + the
``[L, n_blocks, bs, kvh, hd]`` K/V arrays the prefill engine exported)
moves through a :class:`KvTransfer` and the decode side's generated
tokens come back as the reply.

Three transports cover the current deployment shapes:

* :class:`LocalTransfer` — in-process handler dispatch (tests, the
  serving bench's equal-chip comparison);
* :class:`HttpTransfer` — POST the serialized payload to a decode
  replica's ``/v1/kv`` endpoint (the `generate_server` decode role);
* :class:`FileTransfer` — spool-directory handoff for co-located
  processes without a network path (write ``<id>.req.npz``, poll for
  ``<id>.resp.json``; :func:`serve_spool` is the decode-side pump).

A decode replica that is draining answers 503 / ``rejected`` — the
sender raises :class:`TransferRejected` and the prefill side **requeues
the handoff to the next decode target instead of dropping it** (the
disaggregated twin of the engine's ``_prefilling`` drain accounting).

The transfer *configuration* — ``TransferConfig``, serialized as a spec
string in role args (``--kv-transfer``) and AppDef role metadata
(:data:`ROLE_METADATA_KEY`) — is the reusable launcher-managed
inter-role machinery: the MPMD pipeline work reuses the same shape for
inter-stage activation transfer. The TPX213 submit rule enforces that a
prefill/decode role pair declares it.

Everything here is jax-free (numpy only) so the analyze/CLI layers can
import the config types.
"""

from __future__ import annotations

import contextlib
import dataclasses
import io
import json
import os
import threading
import time
import urllib.error
import urllib.request
import uuid
from typing import Callable, Optional, Sequence

import numpy as np

from torchx_tpu_torch.obs import metrics as obs_metrics
from torchx_tpu_torch.obs import trace as obs_trace

__all__ = [
    "ROLE_METADATA_KEY",
    "TransferConfig",
    "TransferRejected",
    "TransferError",
    "KvPayload",
    "stamp_trace",
    "payload_span",
    "KvTransfer",
    "LocalTransfer",
    "HttpTransfer",
    "FileTransfer",
    "serve_spool",
    "make_transfer",
    "new_request_id",
]

#: AppDef role-metadata key carrying the transfer spec — the launcher's
#: declaration that this role participates in inter-role KV streaming.
ROLE_METADATA_KEY = "tpx/kv_transfer"


class TransferRejected(RuntimeError):
    """The decode target refused the handoff (draining/stopping): the
    sender must requeue to another target, not drop the request."""


class TransferError(RuntimeError):
    """Transport-level failure (unreachable target, bad payload)."""


@dataclasses.dataclass
class KvPayload:
    """One prefilled sequence in flight from a prefill to a decode replica.

    ``tokens`` are the ``cache_len`` prompt tokens whose K/V fill
    ``k``/``v`` (``[L, n_blocks, block_size, kvh, hd]``, block-granular);
    ``generated`` holds what prefill already sampled (the first token),
    and the sampling parameters let decode continue the exact PRNG
    stream — per-position fold-in keys make the handoff seamless.
    """

    request_id: str
    tokens: list[int]
    generated: list[int]
    cache_len: int
    max_new_tokens: int
    temperature: float
    seed: int
    eos_id: Optional[int]
    block_size: int
    k: np.ndarray
    v: np.ndarray
    # originating trace context: the decode side opens its spans inside
    # this trace, so router -> prefill -> transfer -> decode stitches
    # into ONE timeline. Defaults keep pre-trace payloads deserializable.
    trace_id: str = ""
    parent_span_id: str = ""

    def meta(self) -> dict:
        """The JSON-scalar side of the payload (everything but K/V)."""
        return {
            "request_id": self.request_id,
            "tokens": self.tokens,
            "generated": self.generated,
            "cache_len": self.cache_len,
            "max_new_tokens": self.max_new_tokens,
            "temperature": self.temperature,
            "seed": self.seed,
            "eos_id": self.eos_id,
            "block_size": self.block_size,
            "trace_id": self.trace_id,
            "parent_span_id": self.parent_span_id,
        }

    def to_bytes(self) -> bytes:
        """npz-serialize (meta as a JSON scalar array + the K/V blocks)."""
        buf = io.BytesIO()
        np.savez(
            buf,
            meta=np.frombuffer(
                json.dumps(self.meta()).encode(), dtype=np.uint8
            ),
            k=self.k,
            v=self.v,
        )
        return buf.getvalue()

    @classmethod
    def from_bytes(cls, raw: bytes) -> "KvPayload":
        """Inverse of :meth:`to_bytes` (pickle-free npz load)."""
        with np.load(io.BytesIO(raw), allow_pickle=False) as z:
            meta = json.loads(z["meta"].tobytes().decode())
            k, v = z["k"], z["v"]
        return cls(k=k, v=v, **meta)


def stamp_trace(payload: KvPayload) -> KvPayload:
    """Fill the payload's trace context from the ambient one (no-op on
    already-stamped payloads): the prefill side calls this right before
    :meth:`KvTransfer.send` so the decode replica joins the request's
    trace. Returns the payload for chaining."""
    if not payload.trace_id:
        payload.trace_id = obs_trace.current_trace_id() or ""
    if not payload.parent_span_id:
        payload.parent_span_id = obs_trace.current_span_id() or ""
    return payload


@contextlib.contextmanager
def payload_span(payload: KvPayload, name: str, **attrs):
    """Open span ``name`` inside the payload's originating trace context
    — the decode-side (and transfer-side) hook that makes a cross-process
    handoff one stitched trace. Yields the open span (or None)."""
    with obs_trace.trace_context(
        payload.trace_id or None, payload.parent_span_id or None
    ):
        with obs_trace.span(
            name, request_id=payload.request_id, **attrs
        ) as sp:
            yield sp


@dataclasses.dataclass(frozen=True)
class TransferConfig:
    """Declared shape of a prefill->decode transfer path.

    Spec grammar (role args / metadata):

    * ``local`` — in-process (tests/bench);
    * ``file:/var/spool/tpx-kv`` — spool directory;
    * ``http:http://127.0.0.1:8100,http://127.0.0.1:8101`` — decode
      replica base URLs, tried in order on rejection.
    """

    mode: str = "local"
    endpoints: tuple[str, ...] = ()

    @classmethod
    def from_spec(cls, spec: str) -> "TransferConfig":
        """Parse a spec string (see the class grammar); raises
        ``ValueError`` on an unknown mode or empty endpoint list."""
        spec = (spec or "").strip()
        if not spec or spec == "local":
            return cls(mode="local")
        if spec.startswith("file:"):
            return cls(mode="file", endpoints=(spec[len("file:") :],))
        if spec.startswith("http:"):
            urls = tuple(
                u if "://" in u else f"http://{u}"
                for u in spec[len("http:") :].split(",")
                if u
            )
            if not urls:
                raise ValueError(f"http transfer spec has no endpoints: {spec!r}")
            return cls(mode="http", endpoints=urls)
        raise ValueError(
            f"unknown kv-transfer spec {spec!r} (expected local | "
            f"file:<dir> | http:<url>[,<url>...])"
        )

    def to_spec(self) -> str:
        """Serialize back to the spec grammar (``from_spec`` inverse)."""
        if self.mode == "local":
            return "local"
        if self.mode == "file":
            return f"file:{self.endpoints[0]}"
        return "http:" + ",".join(self.endpoints)


class KvTransfer:
    """Transport seam: targets + synchronous transfer with reply."""

    def targets(self) -> list[str]:
        """Decode targets, in preference order."""
        raise NotImplementedError

    def transfer(self, payload: KvPayload, target: str, timeout: float = 60.0) -> dict:
        """Deliver ``payload`` to ``target`` and return the decode
        result (``{"tokens": [...], ...}``). Raises
        :class:`TransferRejected` when the target is draining."""
        raise NotImplementedError

    def send(self, payload: KvPayload, timeout: float = 60.0) -> dict:
        """Transfer to the first accepting target, requeueing past
        draining/unreachable ones. The drain-race contract: a target
        that rejects mid-transfer costs a retry, never the request.
        Timed as a ``serve.kv_transfer`` span in the payload's
        originating trace."""
        stamp_trace(payload)
        with payload_span(payload, "serve.kv_transfer") as sp:
            last: Optional[Exception] = None
            for target in self.targets():
                try:
                    out = self.transfer(payload, target, timeout=timeout)
                    obs_metrics.SERVE_KV_TRANSFERS.inc(status="ok")
                    if sp is not None:
                        sp.attrs["target"] = str(target)
                    return out
                except TransferRejected as e:
                    obs_metrics.SERVE_KV_TRANSFERS.inc(status="rejected")
                    last = e
                except TransferError as e:
                    obs_metrics.SERVE_KV_TRANSFERS.inc(status="error")
                    last = e
            raise TransferError(
                f"no decode target accepted request"
                f" {payload.request_id}: {last}"
            )


class LocalTransfer(KvTransfer):
    """In-process transport: targets are named handler callables
    (``payload -> result dict``) that raise :class:`TransferRejected`
    themselves when draining."""

    def __init__(
        self, handlers: dict[str, Callable[[KvPayload], dict]]
    ) -> None:
        self._handlers = dict(handlers)

    def targets(self) -> list[str]:
        return list(self._handlers)

    def transfer(self, payload: KvPayload, target: str, timeout: float = 60.0) -> dict:
        obs_metrics.SERVE_KV_TRANSFER_BYTES.inc(
            payload.k.nbytes + payload.v.nbytes
        )
        return self._handlers[target](payload)


class HttpTransfer(KvTransfer):
    """POST the serialized payload to each decode replica's ``/v1/kv``."""

    def __init__(self, endpoints: Sequence[str]) -> None:
        self._endpoints = list(endpoints)

    def targets(self) -> list[str]:
        return list(self._endpoints)

    def transfer(self, payload: KvPayload, target: str, timeout: float = 60.0) -> dict:
        raw = payload.to_bytes()
        req = urllib.request.Request(
            f"{target.rstrip('/')}/v1/kv",
            data=raw,
            headers={"Content-Type": "application/octet-stream"},
            method="POST",
        )
        try:
            with urllib.request.urlopen(req, timeout=timeout) as resp:
                obs_metrics.SERVE_KV_TRANSFER_BYTES.inc(len(raw))
                return json.loads(resp.read().decode())
        except urllib.error.HTTPError as e:
            if e.code == 503:
                raise TransferRejected(f"{target} draining") from e
            raise TransferError(f"{target}: HTTP {e.code}") from e
        except (urllib.error.URLError, OSError, TimeoutError) as e:
            raise TransferError(f"{target}: {e}") from e


class FileTransfer(KvTransfer):
    """Spool-directory transport: atomic ``<id>.req.npz`` writes, reply
    polled from ``<id>.resp.json`` (written by :func:`serve_spool`)."""

    def __init__(
        self,
        spool_dir: str,
        poll_s: float = 0.01,
        clock: Callable[[], float] = time.monotonic,
        sleep: Callable[[float], None] = time.sleep,
    ) -> None:
        self.spool_dir = spool_dir
        self.poll_s = poll_s
        self._clock = clock
        self._sleep = sleep
        os.makedirs(spool_dir, exist_ok=True)

    def targets(self) -> list[str]:
        return [self.spool_dir]

    def transfer(self, payload: KvPayload, target: str, timeout: float = 60.0) -> dict:
        raw = payload.to_bytes()
        base = os.path.join(target, payload.request_id)
        tmp = f"{base}.tmp"
        with open(tmp, "wb") as f:
            f.write(raw)
        os.replace(tmp, f"{base}.req.npz")  # atomic: readers never see partials
        obs_metrics.SERVE_KV_TRANSFER_BYTES.inc(len(raw))
        resp_path = f"{base}.resp.json"
        deadline = self._clock() + timeout
        while self._clock() < deadline:
            if os.path.exists(resp_path):
                with open(resp_path) as f:
                    out = json.load(f)
                os.unlink(resp_path)
                if out.get("rejected"):
                    raise TransferRejected(f"spool target draining: {target}")
                return out
            self._sleep(self.poll_s)
        raise TransferError(f"no spool reply for {payload.request_id} in {timeout}s")


def serve_spool(
    spool_dir: str,
    handler: Callable[[KvPayload], dict],
    stop: threading.Event,
    poll_s: float = 0.01,
) -> None:
    """Decode-side pump for :class:`FileTransfer`: consume ``*.req.npz``
    oldest-first, run ``handler``, write the ``.resp.json`` reply (a
    :class:`TransferRejected` from the handler becomes a ``rejected``
    reply so the sender requeues)."""
    os.makedirs(spool_dir, exist_ok=True)
    while not stop.is_set():
        reqs = sorted(
            f for f in os.listdir(spool_dir) if f.endswith(".req.npz")
        )
        if not reqs:
            stop.wait(poll_s)
            continue
        path = os.path.join(spool_dir, reqs[0])
        try:
            with open(path, "rb") as f:
                payload = KvPayload.from_bytes(f.read())
        finally:
            os.unlink(path)
        try:
            out = handler(payload)
        except TransferRejected:
            out = {"rejected": True}
        base = path[: -len(".req.npz")]
        tmp = f"{base}.resp.tmp"
        with open(tmp, "w") as f:
            json.dump(out, f)
        os.replace(tmp, f"{base}.resp.json")


def make_transfer(
    cfg: TransferConfig,
    handlers: Optional[dict[str, Callable[[KvPayload], dict]]] = None,
) -> KvTransfer:
    """Instantiate the transport a :class:`TransferConfig` declares
    (``handlers`` backs the ``local`` mode)."""
    if cfg.mode == "local":
        return LocalTransfer(handlers or {})
    if cfg.mode == "file":
        return FileTransfer(cfg.endpoints[0])
    if cfg.mode == "http":
        return HttpTransfer(cfg.endpoints)
    raise ValueError(f"unknown transfer mode {cfg.mode!r}")


def new_request_id() -> str:
    """Collision-free id for one handoff (spool filenames, tracing)."""
    return uuid.uuid4().hex
