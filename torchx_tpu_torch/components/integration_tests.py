"""Component integration-test harness: run real components on a real
scheduler and assert they succeed.

Port of :mod:`torchx_tpu.components.integration_tests` (reference analog:
torchx/components/integration_tests/integ_tests.py:27-60 +
component_provider.py) — a ``ComponentProvider`` owns one component
invocation (setup/appdef/teardown); ``IntegComponentTest`` runs a batch of
providers against a scheduler + image and reports every unsuccessful app
(``IntegComponentTest().assert_all_succeeded()``, local by default). Its
submits pass the runner's preflight gate, so set ``TPX_NO_LINT=1`` until
the port's analyzer lands.
"""

from __future__ import annotations

import abc
import logging
from dataclasses import dataclass, field
from typing import Mapping, Optional, Type

from torchx_tpu_torch.runner.api import get_runner
from torchx_tpu_torch.specs.api import AppDef, AppState, CfgVal

logger = logging.getLogger(__name__)


class ComponentProvider(abc.ABC):
    """One component invocation to validate end-to-end."""

    def __init__(self, scheduler: str, image: str) -> None:
        self._scheduler = scheduler
        self._image = image

    def setUp(self) -> None:  # noqa: N802 (reference naming)
        pass

    def tearDown(self) -> None:  # noqa: N802
        pass

    @abc.abstractmethod
    def get_app_def(self) -> AppDef:
        ...


class EchoProvider(ComponentProvider):
    def get_app_def(self) -> AppDef:
        from torchx_tpu_torch.components.utils import echo

        return echo(msg="integ-echo", image=self._image)


class BoothProvider(ComponentProvider):
    def get_app_def(self) -> AppDef:
        from torchx_tpu_torch.components.utils import booth

        return booth(x1=1.0, x2=3.0, image=self._image)


class SpmdMeshProvider(ComponentProvider):
    """The flagship: SPMD mesh formation, 2 replicas of 2 gloo workers on
    the CPU, running the port's probe app."""

    def get_app_def(self) -> AppDef:
        import os

        import torchx_tpu_torch
        from torchx_tpu_torch.components.dist import spmd

        script = os.path.join(
            os.path.dirname(torchx_tpu_torch.__file__), "examples", "compute_mesh_size.py"
        )
        return spmd(script=script, j="2x2", image=self._image)


DEFAULT_PROVIDERS: list[Type[ComponentProvider]] = [
    EchoProvider,
    BoothProvider,
    SpmdMeshProvider,
]


@dataclass
class IntegResult:
    provider: str
    handle: Optional[str]
    state: Optional[AppState]
    error: Optional[str] = None

    @property
    def ok(self) -> bool:
        return self.state == AppState.SUCCEEDED


@dataclass
class IntegComponentTest:
    scheduler: str = "local"
    image: str = ""
    cfg: Mapping[str, CfgVal] = field(default_factory=dict)
    wait_interval: float = 1.0

    def run_components(
        self, providers: Optional[list[Type[ComponentProvider]]] = None
    ) -> list[IntegResult]:
        results: list[IntegResult] = []
        with get_runner("integ-tests") as runner:
            for provider_cls in providers or DEFAULT_PROVIDERS:
                name = provider_cls.__name__
                provider = provider_cls(self.scheduler, self.image)
                try:
                    provider.setUp()
                    app = provider.get_app_def()
                    handle = runner.run(app, self.scheduler, dict(self.cfg))
                    status = runner.wait(handle, wait_interval=self.wait_interval)
                    results.append(
                        IntegResult(
                            provider=name,
                            handle=handle,
                            state=status.state if status else None,
                        )
                    )
                    logger.info(
                        "%s -> %s (%s)", name, status.state if status else "?", handle
                    )
                except Exception as e:  # noqa: BLE001 - collect, report at end
                    results.append(
                        IntegResult(provider=name, handle=None, state=None, error=str(e))
                    )
                finally:
                    provider.tearDown()
        return results

    def assert_all_succeeded(
        self, providers: Optional[list[Type[ComponentProvider]]] = None
    ) -> None:
        results = self.run_components(providers)
        failures = [r for r in results if not r.ok]
        if failures:
            lines = [
                f"  {r.provider}: state={r.state} error={r.error} handle={r.handle}"
                for r in failures
            ]
            raise AssertionError(
                f"{len(failures)}/{len(results)} component integration tests"
                " failed:\n" + "\n".join(lines)
            )
