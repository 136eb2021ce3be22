"""Base class for component unit tests.

Port of :mod:`torchx_tpu.components.component_test_base` (reference
analog: torchx/components/component_test_base.py:33-121) —
``validate`` runs the AST linter + a ``--help`` argparse round-trip on a
component fn; ``run_component`` materializes and runs it on a scheduler.
Third-party component authors subclass this to test their components the
same way the builtins are tested.
"""

from __future__ import annotations

import unittest
from types import ModuleType
from typing import Callable, Optional

from torchx_tpu_torch.specs.api import AppDef
from torchx_tpu_torch.specs.builders import build_parser, materialize_appdef
from torchx_tpu_torch.specs.file_linter import validate


class ComponentTestCase(unittest.TestCase):
    def validate(self, module: ModuleType, function_name: str) -> None:
        """Assert the component fn passes the AST linter and its argparse
        parser builds (the --help contract)."""
        path = module.__file__
        assert path is not None
        errors = validate(path, function_name)
        self.assertEqual(
            [], [f"{e.line}: {e.description}" for e in errors], f"{function_name}"
        )
        fn = getattr(module, function_name)
        parser, _ = build_parser(fn)
        self.assertTrue(parser.format_help())

    def run_component(
        self,
        component: Callable[..., AppDef],
        args: Optional[list[str]] = None,
        scheduler: str = "local",
        cfg: Optional[dict] = None,
    ) -> str:
        """Materialize + submit the component; returns the app handle."""
        from torchx_tpu_torch.runner.api import get_runner

        app = materialize_appdef(component, args or [])
        with get_runner("component-test") as runner:
            return runner.run(app, scheduler, cfg or {})
