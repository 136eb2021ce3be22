"""MLflow tracker backend.

Port of :mod:`torchx_tpu.tracker.mlflow`.
Reference analog: torchx/tracker/mlflow.py:33-376. Maps tpx runs onto
MLflow runs — run_id -> an MLflow run tagged ``tpx.run_id`` — with the
reference's full artifact and lineage semantics:

* **Artifacts are really logged.** ``add_artifact`` with a local file/dir
  uploads it into the MLflow artifact store (``log_artifact(s)``), so the
  MLflow UI serves the bytes; remote or absent paths are recorded as URI
  pointer tags instead (the reference's remote-artifact behavior). Artifact
  metadata rides a JSON tag. ``artifacts()`` merges the store listing
  (recursive, reference ``get_artifacts``) with pointer tags.
* **Lineage links both ways.** ``add_source`` tags the run with its
  upstream; :meth:`lineage` returns upstream sources AND downstream
  descendants (runs whose source tags reference this run), which is what
  ``tpx tracker lineage`` renders.
* **Structured config logging.** :meth:`log_params_flat` flattens nested
  dataclasses / mappings into dotted MLflow params (reference
  ``log_params_flat``).

The mlflow import is deferred: this module imports cleanly without mlflow
installed and only fails when actually constructed (the environment gates
optional deps; see create()).
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import Any, Iterable, Mapping, Optional

from torchx_tpu_torch.tracker.api import (
    Lineage,
    TrackerArtifact,
    TrackerBase,
    TrackerSource,
)

RUN_ID_TAG = "tpx.run_id"
ARTIFACT_TAG_PREFIX = "tpx.artifact."
ARTIFACT_META_TAG_PREFIX = "tpx.artifact_meta."
SOURCE_TAG_PREFIX = "tpx.source."


class MLflowTracker(TrackerBase):
    def __init__(
        self,
        tracking_uri: Optional[str] = None,
        experiment_name: str = "tpx",
    ) -> None:
        import mlflow

        self._mlflow = mlflow
        self._client = mlflow.tracking.MlflowClient(tracking_uri=tracking_uri)
        exp = self._client.get_experiment_by_name(experiment_name)
        self._experiment_id = (
            exp.experiment_id
            if exp
            else self._client.create_experiment(experiment_name)
        )
        self._run_cache: dict[str, str] = {}  # tpx run id -> mlflow run id

    def _mlflow_run(self, run_id: str) -> str:
        if run_id in self._run_cache:
            return self._run_cache[run_id]
        hits = self._client.search_runs(
            [self._experiment_id], filter_string=f"tags.`{RUN_ID_TAG}` = '{run_id}'"
        )
        if hits:
            mlrun_id = hits[0].info.run_id
        else:
            run = self._client.create_run(
                self._experiment_id, tags={RUN_ID_TAG: run_id}, run_name=run_id
            )
            mlrun_id = run.info.run_id
        self._run_cache[run_id] = mlrun_id
        return mlrun_id

    # -- artifacts ---------------------------------------------------------

    def add_artifact(
        self,
        run_id: str,
        name: str,
        path: str,
        metadata: Optional[Mapping[str, Any]] = None,
    ) -> None:
        mlrun = self._mlflow_run(run_id)
        if os.path.isdir(path):
            self._client.log_artifacts(mlrun, path, artifact_path=name)
            self._client.set_tag(mlrun, f"{ARTIFACT_TAG_PREFIX}{name}", name)
        elif os.path.isfile(path):
            self._client.log_artifact(mlrun, path, artifact_path=name)
            self._client.set_tag(mlrun, f"{ARTIFACT_TAG_PREFIX}{name}", name)
        else:
            # remote / not-locally-materialized artifact: record the URI
            self._client.set_tag(mlrun, f"{ARTIFACT_TAG_PREFIX}{name}", path)
        if metadata:
            self._client.set_tag(
                mlrun,
                f"{ARTIFACT_META_TAG_PREFIX}{name}",
                json.dumps(dict(metadata), default=str),
            )

    def artifacts(self, run_id: str) -> Mapping[str, TrackerArtifact]:
        mlrun = self._mlflow_run(run_id)
        run = self._client.get_run(mlrun)
        metas: dict[str, Mapping[str, Any]] = {}
        pointers: dict[str, str] = {}
        for tag, value in run.data.tags.items():
            if tag.startswith(ARTIFACT_META_TAG_PREFIX):
                try:
                    metas[tag[len(ARTIFACT_META_TAG_PREFIX) :]] = json.loads(value)
                except ValueError:
                    pass
            elif tag.startswith(ARTIFACT_TAG_PREFIX):
                pointers[tag[len(ARTIFACT_TAG_PREFIX) :]] = value
        out: dict[str, TrackerArtifact] = {}
        base = run.info.artifact_uri
        for name, value in pointers.items():
            if value == name:
                # logged into the store: resolve to the artifact URI
                value = f"{base}/{name}"
            out[name] = TrackerArtifact(
                name=name, path=value, metadata=metas.get(name)
            )
        # store entries logged outside add_artifact still surface
        for item in self._list_artifacts_recursive(mlrun):
            root = item.split("/", 1)[0]
            if root not in out:
                out[root] = TrackerArtifact(
                    name=root, path=f"{base}/{root}", metadata=metas.get(root)
                )
        return out

    def _list_artifacts_recursive(self, mlrun: str) -> Iterable[str]:
        stack = [""]
        while stack:
            prefix = stack.pop()
            for info in self._client.list_artifacts(mlrun, prefix or None):
                if info.is_dir:
                    stack.append(info.path)
                else:
                    yield info.path

    # -- metadata ----------------------------------------------------------

    def add_metadata(self, run_id: str, **kwargs: Any) -> None:
        mlrun = self._mlflow_run(run_id)
        for key, value in kwargs.items():
            if isinstance(value, bool) or not isinstance(value, (int, float)):
                self._client.log_param(mlrun, key, value)
            else:
                self._client.log_metric(mlrun, key, float(value))

    def metadata(self, run_id: str) -> Mapping[str, Any]:
        run = self._client.get_run(self._mlflow_run(run_id))
        out: dict[str, Any] = dict(run.data.params)
        out.update(run.data.metrics)
        return out

    def log_params_flat(self, run_id: str, config: Any, prefix: str = "") -> None:
        """Flatten a nested config (dataclass / mapping / primitives) into
        dotted MLflow params: ``{"opt": {"lr": 3e-4}}`` -> ``opt.lr=0.0003``
        (reference mlflow.py log_params_flat)."""
        flat: dict[str, Any] = {}

        def walk(obj: Any, path: str) -> None:
            if dataclasses.is_dataclass(obj) and not isinstance(obj, type):
                obj = dataclasses.asdict(obj)
            if isinstance(obj, Mapping):
                for k, v in obj.items():
                    walk(v, f"{path}.{k}" if path else str(k))
            elif isinstance(obj, (list, tuple)):
                flat[path] = json.dumps(list(obj), default=str)
            else:
                flat[path] = obj

        walk(config, prefix)
        self.add_metadata(run_id, **{k: v for k, v in flat.items() if k})

    # -- lineage -----------------------------------------------------------

    def add_source(
        self, run_id: str, source_id: str, artifact_name: Optional[str] = None
    ) -> None:
        existing = list(self.sources(run_id))
        self._client.set_tag(
            self._mlflow_run(run_id),
            f"{SOURCE_TAG_PREFIX}{len(existing)}",
            f"{source_id}|{artifact_name or ''}",
        )

    def sources(
        self, run_id: str, artifact_name: Optional[str] = None
    ) -> Iterable[TrackerSource]:
        run = self._client.get_run(self._mlflow_run(run_id))
        # numeric sort on the tag index: "…source.10" must come after
        # "…source.2", which lexicographic sorting would scramble
        source_tags = [
            (tag, value)
            for tag, value in run.data.tags.items()
            if tag.startswith(SOURCE_TAG_PREFIX)
        ]

        def _idx(kv: tuple[str, str]) -> int:
            suffix = kv[0][len(SOURCE_TAG_PREFIX):]
            return int(suffix) if suffix.isdigit() else 0

        for tag, value in sorted(source_tags, key=_idx):
            src, _, art = value.partition("|")
            source = TrackerSource(source_run_id=src, artifact_name=art or None)
            if artifact_name is None or source.artifact_name == artifact_name:
                yield source

    def _all_runs(self) -> Iterable[Any]:
        """Every run in the experiment, following page tokens —
        ``search_runs`` returns a single page (default ``max_results``),
        so reverse lineage would silently miss runs in large experiments."""
        token: Optional[str] = None
        while True:
            page = self._client.search_runs(
                [self._experiment_id], page_token=token
            )
            yield from page
            token = getattr(page, "token", None)
            if not token:
                return

    def descendants(self, run_id: str) -> Iterable[str]:
        """Runs that declared ``run_id`` as a source (downstream links)."""
        for run in self._all_runs():
            rid = run.data.tags.get(RUN_ID_TAG)
            if not rid or rid == run_id:
                continue
            for tag, value in run.data.tags.items():
                if tag.startswith(SOURCE_TAG_PREFIX) and (
                    value.partition("|")[0] == run_id
                ):
                    yield rid
                    break

    def lineage(self, run_id: str) -> Lineage:
        return Lineage(
            run_id=run_id,
            sources=list(self.sources(run_id)),
            descendants=list(self.descendants(run_id)),
        )

    def run_ids(self, **kwargs: str) -> Iterable[str]:
        """All tracked run ids; ``source_run_id=<id>`` filters to runs
        downstream of that id (reference run_ids parent filtering)."""
        source = kwargs.get("source_run_id") or kwargs.get("parent_run_id")
        if source:
            yield from self.descendants(source)
            return
        for run in self._all_runs():
            rid = run.data.tags.get(RUN_ID_TAG)
            if rid:
                yield rid


def create(config: Optional[str]) -> MLflowTracker:
    """Factory. config: ``[tracking_uri][;experiment=<name>]``."""
    tracking_uri: Optional[str] = None
    experiment = "tpx"
    if config:
        for part in config.split(";"):
            part = part.strip()
            if not part:
                continue
            if part.startswith("experiment="):
                experiment = part.split("=", 1)[1]
            else:
                tracking_uri = part
    return MLflowTracker(tracking_uri=tracking_uri, experiment_name=experiment)
