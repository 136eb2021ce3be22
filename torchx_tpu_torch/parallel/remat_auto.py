"""Automatic remat policy selection from the traced memory fit.

The port of :mod:`torchx_tpu.parallel.remat_auto`. The remat policy is a
trade of memory for recompute: ``dots_attn`` saves the most activations
(the cheapest backward, the largest footprint), ``dots`` recomputes the
attention forward, ``full`` recomputes every layer's forward. The right
choice depends on batch, sequence, mesh and model size.

``remat_policy="auto"`` resolves the choice at launch: each candidate
policy, cheapest recompute first, is traced for one training step on
meta tensors (:func:`torchx_tpu_torch.parallel.aot_fit.trace_fit`), its
rank-0 peak is checked against the card's memory budget, and the first
policy that fits wins. The trainer resolves ``"auto"`` before the first
step (a gang once, on rank 0, against the smallest card of the gang) and
reports the policy and the trials in its results.
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable, Optional

from torchx_tpu_torch.parallel.aot_fit import (
    DEFAULT_HEADROOM,
    H100_HBM_BYTES,
    FitResult,
    trace_fit,
)

#: candidate policies, cheapest recompute (largest footprint) first: the
#: selection order; stop at the first one whose traced step fits.
POLICY_ORDER: tuple[str, ...] = ("dots_attn", "dots", "full")


@dataclasses.dataclass
class PolicyTrial:
    """One candidate policy's fit verdict (for logs and the trainer's
    results)."""

    policy: str
    fits: bool
    peak_bytes: int  # 0 when the trial failed
    error: Optional[str] = None


def device_hbm_bytes(default: int = H100_HBM_BYTES) -> int:
    """The memory budget of this process's card: the current CUDA device's
    ``total_memory`` where there is one, else ``default`` (an H100 80GB,
    so that a selection off the card stays meaningful)."""
    import torch

    if not torch.cuda.is_available():
        return default
    return torch.cuda.get_device_properties(torch.cuda.current_device()).total_memory


def choose_remat_policy(
    cfg: Any,
    mesh: Any,
    batch: int,
    seq: int,
    *,
    hbm_bytes: Optional[int] = None,
    headroom: float = DEFAULT_HEADROOM,
    fit_fn: Optional[Callable[[Any], FitResult]] = None,
) -> tuple[str, list[PolicyTrial]]:
    """Resolve ``remat_policy="auto"`` -> a concrete policy for this run.

    Tries :data:`POLICY_ORDER` in sequence and returns the first policy
    whose traced training step fits ``hbm_bytes * headroom`` on rank 0 of
    ``mesh`` (a mesh spec or ``MeshConfig``; None for one card), plus the
    trial records. If nothing fits (or every trial fails) the answer is
    ``"full"``: the most recompute is the only lever left, and the run
    itself reports the out-of-memory error.

    ``fit_fn`` overrides the fit oracle (a callable taking the candidate
    config and returning a :class:`~torchx_tpu_torch.parallel.aot_fit.FitResult`):
    tests inject fits, and a gang passes the results of a subprocess
    probe; the default traces in this process with
    :func:`~torchx_tpu_torch.parallel.aot_fit.trace_fit`.
    """
    budget = hbm_bytes if hbm_bytes is not None else device_hbm_bytes()
    if fit_fn is None:
        fit_fn = lambda c: trace_fit(  # noqa: E731
            c, mesh, batch, seq, hbm_bytes=budget, headroom=headroom
        )
    trials: list[PolicyTrial] = []
    for policy in POLICY_ORDER:
        candidate = dataclasses.replace(cfg, remat=True, remat_policy=policy)
        try:
            res = fit_fn(candidate)
        except Exception as e:  # noqa: BLE001 - a failed trial is a verdict
            trials.append(PolicyTrial(policy=policy, fits=False, peak_bytes=0, error=str(e)))
            continue
        trials.append(PolicyTrial(policy=policy, fits=res.fits, peak_bytes=res.peak_bytes))
        if res.fits:
            return policy, trials
    return "full", trials
