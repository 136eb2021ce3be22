"""Per-step phase attribution: where a training step's time goes.

Port of :mod:`torchx_tpu.obs.profile`. Each profiled step is split into
named phases:

* ``data_wait`` — host blocked on input (measured by the prefetcher's wait
  hook, :meth:`~torchx_tpu_torch.parallel.prefetch.Prefetcher.set_wait_observer`);
* ``forward_backward`` — the fenced device step minus the attributed
  optimizer and exposed-collective slices;
* ``grad_sync`` per mesh axis — the exposed (unoverlapped) collective time
  attributed from the measured device residual;
* ``optimizer`` — the modeled elementwise AdamW update slice;
* ``checkpoint`` / ``host`` — measured save and log/emit time.

The trainer measures what a host can measure (wall step, the fenced device
call, input waits, checkpoint saves, log emission); the device slice is
split by arithmetic: the roofline compute floor from the model's FLOPs per
token, the modeled optimizer slice ``12 x param_count / peak``, and the
modeled per-axis collective seconds. The residual above the compute floor
is attributed between compute slack and exposed collectives in proportion
to their modeled shares: an attribution model, not a hardware counter.
:func:`_attribute` is the reference's, unchanged, so the port's records
equal the JAX trainer's for the same measured inputs and ``tpx profile``
reads either.

Without a mesh the collective terms are zero and the overlap fraction is
None. Under one, :func:`modeled_collective_seconds` gives each live axis
(``fsdp``, ``dp``, ``tp``, ``sp``) the cost model's bytes
(:mod:`torchx_tpu_torch.analyze.costmodel`, the reference's) over the
card's link rate. The reference's calibration fold (``feed_calibration``)
comes with the port's calibration table (ROADMAP queue 1 item 2, the
launcher layers); :meth:`StepProfiler.close` folds nothing.

Records append to ``profile.jsonl`` in the obs session dir (fsync'd,
single-line ``O_APPEND`` writes) next to ``trace.jsonl``; the reader keeps
a torn final line out. Summaries also export as ``tpx_profile_*`` gauges.
Durations come from ``time.perf_counter``; record timestamps from the
injected ``clock``.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import logging
import os
import time
from typing import Any, Callable, Iterator, Optional

logger = logging.getLogger(__name__)

#: the profile journal's filename inside an obs session dir.
PROFILE_FILE = "profile.jsonl"

#: stable schema version for records, ``--json`` summaries, and diffs.
SCHEMA_VERSION = 1

#: phases every profiled trainer run reports with nonzero totals.
CORE_PHASES = ("data_wait", "forward_backward", "optimizer", "host")

#: render/summary order of all scalar phases (``grad_sync`` is per-axis
#: and rides its own record key).
PHASES = ("data_wait", "forward_backward", "optimizer", "checkpoint", "host")

#: modeled AdamW update arithmetic per parameter (grad + two moments +
#: weight-decayed apply, a dozen elementwise ops). The reference's model,
#: kept for parity of the records: on an H100 the update is bound by the
#: memory rate, far above this FLOP floor (PERF.md).
OPTIMIZER_FLOPS_PER_PARAM = 12.0

#: MFU the compute floor assumes for the compute-slack share (a copy of
#: ``torchx_tpu.tune.rank.ASSUMED_MFU``).
ASSUMED_MFU = 0.5


@dataclasses.dataclass(frozen=True)
class AttributionModel:
    """The static arithmetic a :class:`StepProfiler` splits device time
    with: the FLOP contract, the peak the trainer uses for MFU, the
    parameter count and the modeled per-axis serialized-collective
    seconds (empty on one card)."""

    flops_per_token: float
    tokens_per_step: int
    peak_flops: float  # aggregate over all devices
    param_count: int
    comm_axis_s: dict[str, float] = dataclasses.field(default_factory=dict)
    generation: str = ""

    @property
    def ideal_compute_s(self) -> float:
        """Roofline floor: step seconds at 100% MFU."""
        if self.peak_flops <= 0:
            return 0.0
        return self.tokens_per_step * self.flops_per_token / self.peak_flops

    @property
    def optimizer_s(self) -> float:
        """Modeled elementwise optimizer-update seconds per step."""
        if self.peak_flops <= 0:
            return 0.0
        return OPTIMIZER_FLOPS_PER_PARAM * self.param_count / self.peak_flops

    @property
    def total_comm_s(self) -> float:
        """Modeled serialized collective seconds per step (all axes)."""
        return sum(self.comm_axis_s.values())

    @property
    def compute_slack_s(self) -> float:
        """Modeled compute time beyond the 100%-MFU floor at the assumed
        MFU: the non-collective share of any residual."""
        return self.ideal_compute_s * (1.0 / ASSUMED_MFU - 1.0)

    def to_dict(self) -> dict:
        """Stable JSON form (the journal's ``meta`` record body)."""
        return {
            "flops_per_token": self.flops_per_token,
            "tokens_per_step": self.tokens_per_step,
            "peak_flops": self.peak_flops,
            "param_count": self.param_count,
            "comm_modeled_axis_s": dict(sorted(self.comm_axis_s.items())),
            "generation": self.generation,
        }


def modeled_collective_seconds(plan: Any, *, generation: str = "") -> dict[str, float]:
    """Per-axis modeled serialized collective seconds for one step: the
    cost model's bytes (``collective_traffic``) over the link rate of
    ``generation`` (a card's name;
    :func:`~torchx_tpu_torch.analyze.costmodel.link_bytes_per_s`)."""
    from torchx_tpu_torch.analyze import costmodel

    bw = costmodel.link_bytes_per_s(generation)
    out: dict[str, float] = {}
    for t in costmodel.collective_traffic(plan):
        out[t.axis] = out.get(t.axis, 0.0) + t.bytes_per_step / bw
    return out


def attribution_model(
    *,
    flops_per_token: float,
    tokens_per_step: int,
    peak_flops: float,
    param_count: int,
    plan: Any = None,
    generation: str = "",
) -> AttributionModel:
    """Build the :class:`AttributionModel` for one training run.

    ``plan`` (a :class:`~torchx_tpu_torch.analyze.costmodel.ParallelPlan`)
    supplies the per-axis collective model; without one the comm terms are
    zero (single-device runs have nothing to overlap)."""
    comm: dict[str, float] = {}
    if plan is not None:
        comm = modeled_collective_seconds(plan, generation=generation)
    return AttributionModel(
        flops_per_token=float(flops_per_token),
        tokens_per_step=int(tokens_per_step),
        peak_flops=float(peak_flops),
        param_count=int(param_count),
        comm_axis_s=comm,
        generation=generation,
    )


def profile_path(session: Optional[str] = None) -> str:
    """The session's profile journal path (``<session dir>/profile.jsonl``)."""
    from torchx_tpu_torch.obs import sinks

    return os.path.join(sinks.session_dir(session), PROFILE_FILE)


class StepProfiler:
    """Records per-step phase segments and appends attributed records.

    The trainer drives it with :meth:`begin_step` / :meth:`phase`
    context-manager hooks / :meth:`end_step`; externally measured slices
    (the prefetcher's wait hook) arrive via :meth:`observe_wait`. Each
    finished step is attributed, kept in memory for the end-of-run
    summary, and appended to the journal with an fsync, so a kill leaves
    at most one torn final line.

    ``clock`` stamps records with wall time; durations always come from
    ``time.perf_counter``.
    """

    def __init__(
        self,
        model: AttributionModel,
        *,
        path: Optional[str] = None,
        session: Optional[str] = None,
        clock: Callable[[], float] = time.time,
    ) -> None:
        self.model = model
        self.path = path or profile_path(session)
        self._clock = clock
        self._pending: dict[str, float] = {}
        self._step_t0: Optional[float] = None
        self._records: list[dict] = []
        self._wrote_meta = False
        self._journal_ok = True

    # -- recording hooks ---------------------------------------------------

    def begin_step(self) -> None:
        """Open a step window; pending segments from outside a window
        (warm-up waits) are discarded."""
        self._pending = {}
        self._step_t0 = time.perf_counter()

    @contextlib.contextmanager
    def phase(self, name: str) -> Iterator[None]:
        """Accrue the block's ``perf_counter`` duration to phase ``name``."""
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._pending[name] = (
                self._pending.get(name, 0.0) + time.perf_counter() - t0
            )

    def observe_wait(self, seconds: float) -> None:
        """Credit externally measured input-wait seconds to ``data_wait``
        (the :meth:`Prefetcher.set_wait_observer` callback target)."""
        self._pending["data_wait"] = self._pending.get("data_wait", 0.0) + float(
            seconds
        )

    def end_step(self, step: int) -> Optional[dict]:
        """Close the step window: attribute, record, append. -> the
        record, or None without a matching :meth:`begin_step`."""
        if self._step_t0 is None:
            return None
        wall = time.perf_counter() - self._step_t0
        self._step_t0 = None
        measured, self._pending = self._pending, {}
        return self.record_step(step, wall_s=wall, measured=measured)

    def record_step(
        self, step: int, *, wall_s: float, measured: dict[str, float]
    ) -> dict:
        """Attribute one step from externally measured phase seconds
        (what the hooks collect; exposed directly for replayed steps and
        tests) and append its record."""
        rec = self._attribute(step, wall_s, measured)
        self._records.append(rec)
        self._append(rec)
        return rec

    # -- attribution -------------------------------------------------------

    def _attribute(
        self, step: int, wall_s: float, measured: dict[str, float]
    ) -> dict:
        """Split the measured slices into the full phase record.

        The fenced device call (``forward_backward`` as measured) fuses
        compute, grad collectives, and the optimizer; the split assigns
        it the modeled optimizer slice, then attributes the residual
        above the roofline compute floor between compute slack and
        exposed collectives in proportion to their modeled shares.
        Phase seconds sum back to the measured slices by construction.
        """
        m = self.model
        device_s = max(0.0, float(measured.get("forward_backward", 0.0)))
        opt_s = min(m.optimizer_s, 0.5 * device_s)
        residual = max(0.0, device_s - m.ideal_compute_s - opt_s)
        total_comm = m.total_comm_s
        exposed = 0.0
        if total_comm > 0.0 and residual > 0.0:
            share = total_comm / (total_comm + m.compute_slack_s)
            exposed = residual * share
        grad_sync = {
            axis: exposed * (s / total_comm)
            for axis, s in sorted(m.comm_axis_s.items())
        } if total_comm > 0.0 else {}
        phases = {
            "data_wait": float(measured.get("data_wait", 0.0)),
            "forward_backward": max(0.0, device_s - opt_s - exposed),
            "optimizer": opt_s,
            "checkpoint": float(measured.get("checkpoint", 0.0)),
            "host": float(measured.get("host", 0.0)),
        }
        mfu = 0.0
        if wall_s > 0 and m.peak_flops > 0:
            mfu = m.tokens_per_step * m.flops_per_token / (wall_s * m.peak_flops)
        overlap = None
        if total_comm > 0.0:
            overlap = 1.0 - min(exposed, total_comm) / total_comm
        return {
            "v": SCHEMA_VERSION,
            "kind": "step",
            "step": int(step),
            "ts": self._clock(),
            "wall_s": float(wall_s),
            "phases": phases,
            "grad_sync": grad_sync,
            "tokens": m.tokens_per_step,
            "mfu": mfu,
            "comm_exposed_s": exposed,
            "comm_modeled_s": total_comm,
            "overlap_frac": overlap,
        }

    # -- journal -----------------------------------------------------------

    def _append(self, rec: dict) -> None:
        """Fsync'd single-line ``O_APPEND`` write (meta record first).
        Best-effort after the first failure: profiling never takes down
        the training job over a full disk."""
        if not self._journal_ok:
            return
        try:
            parent = os.path.dirname(self.path)
            if parent:
                os.makedirs(parent, exist_ok=True)
            payload = b""
            if not self._wrote_meta:
                meta = {
                    "v": SCHEMA_VERSION,
                    "kind": "meta",
                    "ts": self._clock(),
                    "pid": os.getpid(),
                    "model": self.model.to_dict(),
                }
                payload += json.dumps(meta, sort_keys=True).encode() + b"\n"
            payload += json.dumps(rec, sort_keys=True).encode() + b"\n"
            fd = os.open(self.path, os.O_CREAT | os.O_WRONLY | os.O_APPEND, 0o644)
            try:
                os.write(fd, payload)
                os.fsync(fd)
            finally:
                os.close(fd)
            self._wrote_meta = True
        except OSError as e:
            self._journal_ok = False
            logger.warning("profile journal unavailable (%s): %s", self.path, e)

    # -- end of run --------------------------------------------------------

    def close(self, *, calibrate: bool = True) -> dict:
        """Summarize the run and export the ``tpx_profile_*`` gauges.
        -> the summary (stable ``--json`` schema).

        ``calibrate`` is the reference's switch for folding measured
        collective seconds into its calibration table; the port has no
        table yet (ROADMAP queue 1 item 2), so nothing is folded either way."""
        summary = summarize(
            self._records,
            meta={"v": SCHEMA_VERSION, "kind": "meta", "model": self.model.to_dict()},
        )
        export_metrics(summary)
        if calibrate:
            logger.debug("collective calibration is not ported yet; nothing folded")
        return summary


# -- reading / summarizing ---------------------------------------------------


def load_profile(target: str) -> list[dict]:
    """Records of one profile journal, a torn final line skipped.

    ``target`` is the journal file itself or a session directory
    containing ``profile.jsonl``."""
    path = target
    if os.path.isdir(target):
        path = os.path.join(target, PROFILE_FILE)
    from torchx_tpu_torch.obs.timeline import load_records

    return load_records(path)


def summarize(records: list[dict], meta: Optional[dict] = None) -> dict:
    """Aggregate step records into the stable ``tpx profile --json`` schema.

    Per-phase totals and fractions (of summed wall time), per-axis
    ``grad_sync`` seconds, mean MFU, data-wait fraction, and the
    aggregate overlap fraction ``1 - Σexposed / Σmodeled``.
    """
    steps = [r for r in records if r.get("kind") == "step"]
    if meta is None:
        meta = next((r for r in records if r.get("kind") == "meta"), None)
    phase_seconds: dict[str, float] = {}
    grad_sync: dict[str, float] = {}
    wall = exposed = modeled = 0.0
    tokens = 0
    mfus: list[float] = []
    for r in steps:
        wall += float(r.get("wall_s", 0.0))
        exposed += float(r.get("comm_exposed_s", 0.0))
        modeled += float(r.get("comm_modeled_s", 0.0))
        tokens += int(r.get("tokens", 0))
        mfus.append(float(r.get("mfu", 0.0)))
        for ph, s in (r.get("phases") or {}).items():
            phase_seconds[ph] = phase_seconds.get(ph, 0.0) + float(s)
        for axis, s in (r.get("grad_sync") or {}).items():
            grad_sync[axis] = grad_sync.get(axis, 0.0) + float(s)
    n = len(steps)
    data_wait = phase_seconds.get("data_wait", 0.0)
    return {
        "v": SCHEMA_VERSION,
        "steps": n,
        "wall_s": wall,
        "step_s": wall / n if n else 0.0,
        "tokens": tokens,
        "phase_seconds": {k: phase_seconds[k] for k in sorted(phase_seconds)},
        "phase_fracs": {
            k: (phase_seconds[k] / wall if wall > 0 else 0.0)
            for k in sorted(phase_seconds)
        },
        "grad_sync_seconds": {k: grad_sync[k] for k in sorted(grad_sync)},
        "mfu": sum(mfus) / n if n else 0.0,
        "data_wait_frac": data_wait / wall if wall > 0 else 0.0,
        "comm_exposed_s": exposed,
        "comm_modeled_s": modeled,
        "overlap_frac": (
            1.0 - min(exposed, modeled) / modeled if modeled > 0 else None
        ),
        "meta": (meta or {}).get("model", {}) if meta else {},
    }


def diff_summaries(a: dict, b: dict) -> dict:
    """Before/after comparison of two summaries (``tpx profile --diff``).

    Tolerates disjoint phase sets (a phase absent on one side reads as
    0.0): the union of phases is compared.
    """

    def _scalar(key: str) -> dict:
        va, vb = a.get(key), b.get(key)
        out = {"a": va, "b": vb}
        if isinstance(va, (int, float)) and isinstance(vb, (int, float)):
            out["delta"] = vb - va
        return out

    phases: dict[str, dict] = {}
    pa = dict(a.get("phase_seconds") or {})
    pb = dict(b.get("phase_seconds") or {})
    na, nb = max(1, int(a.get("steps") or 0)), max(1, int(b.get("steps") or 0))
    for ph in sorted(set(pa) | set(pb)):
        sa, sb = pa.get(ph, 0.0) / na, pb.get(ph, 0.0) / nb
        phases[ph] = {"a": sa, "b": sb, "delta": sb - sa}
    return {
        "v": SCHEMA_VERSION,
        "steps": {"a": a.get("steps"), "b": b.get("steps")},
        "step_s": _scalar("step_s"),
        "mfu": _scalar("mfu"),
        "data_wait_frac": _scalar("data_wait_frac"),
        "overlap_frac": _scalar("overlap_frac"),
        "phase_step_s": phases,
    }


# -- rendering ---------------------------------------------------------------


def _fmt_s(v: float) -> str:
    if v >= 1.0:
        return f"{v:.3f}s"
    return f"{v * 1e3:.2f}ms"


def render_summary(summary: dict) -> str:
    """The ``tpx profile`` text view: per-phase timeline bars + the
    roofline/MFU and overlap lines."""
    n = summary.get("steps") or 0
    wall = float(summary.get("wall_s") or 0.0)
    lines = [
        f"profile: {n} step(s), {_fmt_s(wall)} wall,"
        f" {_fmt_s(summary.get('step_s') or 0.0)}/step"
    ]
    fracs = summary.get("phase_fracs") or {}
    seconds = summary.get("phase_seconds") or {}
    rows: list[tuple[str, float, float]] = []
    for ph in PHASES:
        if ph in seconds:
            rows.append((ph, seconds[ph], fracs.get(ph, 0.0)))
    for ph in sorted(set(seconds) - set(PHASES)):
        rows.append((ph, seconds[ph], fracs.get(ph, 0.0)))
    for axis, s in sorted((summary.get("grad_sync_seconds") or {}).items()):
        rows.append((f"grad_sync[{axis}]", s, s / wall if wall > 0 else 0.0))
    if rows:
        lines.append(f"  {'phase':<18} {'total':>9} {'frac':>7}")
        peak_frac = max((f for _, _, f in rows), default=0.0)
        for name, sec, frac in rows:
            bar = "#" * int(round(24 * frac / peak_frac)) if peak_frac > 0 else ""
            lines.append(f"  {name:<18} {_fmt_s(sec):>9} {frac:>6.1%}  {bar}")
    model = summary.get("meta") or {}
    mfu = summary.get("mfu") or 0.0
    peak = float(model.get("peak_flops") or 0.0)
    ideal = ""
    if peak > 0 and n:
        ideal_s = (
            float(model.get("tokens_per_step") or 0)
            * float(model.get("flops_per_token") or 0)
            / peak
        )
        ideal = f"  ideal {_fmt_s(ideal_s)}/step at 100% MFU"
    lines.append(f"roofline: MFU {mfu:.2%}{ideal}")
    modeled = float(summary.get("comm_modeled_s") or 0.0)
    if modeled > 0 and n:
        exposed = float(summary.get("comm_exposed_s") or 0.0)
        overlap = summary.get("overlap_frac")
        lines.append(
            f"overlap: modeled comm {_fmt_s(modeled / n)}/step,"
            f" exposed {_fmt_s(exposed / n)}/step"
            f" -> {overlap:.1%} overlapped"
        )
    else:
        lines.append("overlap: no modeled collective traffic (single axis?)")
    return "\n".join(lines)


def render_diff(diff: dict) -> str:
    """The ``tpx-torch profile --diff`` text view over :func:`diff_summaries`."""

    def _num(v: Any, pct: bool = False) -> str:
        if not isinstance(v, (int, float)):
            return "-"
        return f"{v:.1%}" if pct else _fmt_s(float(v))

    steps = diff.get("steps") or {}
    lines = [
        f"profile diff: a={steps.get('a')} step(s), b={steps.get('b')} step(s)",
        f"  {'phase':<18} {'a/step':>9} {'b/step':>9} {'delta':>9}",
    ]
    for ph, row in (diff.get("phase_step_s") or {}).items():
        delta = row.get("delta", 0.0)
        sign = "+" if delta >= 0 else "-"
        lines.append(
            f"  {ph:<18} {_num(row.get('a')):>9} {_num(row.get('b')):>9}"
            f" {sign}{_fmt_s(abs(delta)):>8}"
        )
    for key, pct in (("step_s", False), ("mfu", True), ("data_wait_frac", True), ("overlap_frac", True)):
        row = diff.get(key) or {}
        lines.append(
            f"  {key:<18} {_num(row.get('a'), pct):>9} {_num(row.get('b'), pct):>9}"
        )
    return "\n".join(lines)


# -- exports -----------------------------------------------------------------


def export_metrics(summary: dict) -> None:
    """Publish a summary as the process's ``tpx_profile_*`` gauges and
    flush the metrics textfile. Best-effort: metrics never fail the run."""
    try:
        from torchx_tpu_torch.obs import metrics as obs_metrics
        from torchx_tpu_torch.obs import sinks

        n = max(1, int(summary.get("steps") or 0))
        for ph, sec in (summary.get("phase_seconds") or {}).items():
            obs_metrics.PROFILE_PHASE_SECONDS.set(sec / n, phase=ph)
        for axis, sec in (summary.get("grad_sync_seconds") or {}).items():
            obs_metrics.PROFILE_PHASE_SECONDS.set(
                sec / n, phase=f"grad_sync[{axis}]"
            )
        obs_metrics.PROFILE_MFU.set(float(summary.get("mfu") or 0.0))
        obs_metrics.PROFILE_DATA_WAIT_FRAC.set(
            float(summary.get("data_wait_frac") or 0.0)
        )
        overlap = summary.get("overlap_frac")
        if overlap is not None:
            obs_metrics.PROFILE_OVERLAP_FRAC.set(float(overlap))
        sinks.flush_metrics()
    except Exception as e:  # noqa: BLE001 - metrics export is best-effort
        logger.debug("profile metrics export failed: %s", e)
