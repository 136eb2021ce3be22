"""The port's control-plane resilience (``torchx_tpu_torch.resilience``):
the cases of ``tests/test_resilience.py`` that need only the layers ported
so far, run against the copy, and the copy held to the JAX package's
``torchx_tpu.resilience`` on the same seeded inputs: the failure kind each
text, process and exception classifies to, a policy's backoff sequence
under one ``random.Random`` seed, and ``resilient_call``'s attempts, sleeps
and metric increments under one fault plan.

That file's ``TestPollMissBudget`` runs against the port's runner in
``tests/test_torch_runner.py``; ``TestAttemptLedger``,
``TestSupervisorResume`` and ``TestAcceptance`` run against the port's
supervisor in ``tests/test_torch_supervisor.py``; ``TestResilienceRules``
waits for the analyzer (ROADMAP queue 1 item 2.8).
"""

import random
import subprocess

import pytest

from torchx_tpu import resilience as jres
from torchx_tpu.obs import metrics as jmetrics
from torchx_tpu.resilience import call as jcall
from torchx_tpu.resilience import faults as jfaults
from torchx_tpu_torch import resilience as tres
from torchx_tpu_torch import settings
from torchx_tpu_torch.obs import metrics as obs_metrics
from torchx_tpu_torch.resilience import (
    BreakerOpenError,
    BreakerState,
    CallPolicy,
    CircuitBreaker,
    FailureKind,
    FailureLedger,
    FaultInjector,
    FaultPlan,
    FaultRule,
    PermanentSchedulerError,
    TransientSchedulerError,
    classify_exception,
    classify_proc,
    classify_text,
    is_transient,
)
from torchx_tpu_torch.resilience import call as tcall
from torchx_tpu_torch.resilience import faults as resilience_faults
from torchx_tpu_torch.resilience.call import (
    TIMEOUT_RETURNCODE,
    breaker_for,
    control_plane_timeout,
    resilient_call,
    resilient_cmd,
)
from torchx_tpu_torch.resilience.faults import GARBAGE_PAYLOAD, fault_plan_active
from torchx_tpu_torch.resilience.policy import NON_IDEMPOTENT
from torch_threads import xdist_torch_threads  # noqa: F401


def fast_call_policy(**kwargs) -> CallPolicy:
    defaults = dict(backoff_seconds=0.0, jitter=0.0)
    defaults.update(kwargs)
    return CallPolicy(**defaults)


def proc(rc: int, stderr: str = "", stdout: str = "") -> subprocess.CompletedProcess:
    return subprocess.CompletedProcess(
        args=["fake"], returncode=rc, stdout=stdout, stderr=stderr
    )


# -- classifier ------------------------------------------------------------


class TestClassifier:
    @pytest.mark.parametrize(
        "text,kind",
        [
            ("HTTP 429: Too Many Requests", FailureKind.RATE_LIMIT),
            ("Quota exceeded for quota metric 'TPU v5e'", FailureKind.QUOTA),
            ("RESOURCE_EXHAUSTED: out of capacity", FailureKind.QUOTA),
            ("DEADLINE_EXCEEDED while polling operation", FailureKind.TIMEOUT),
            ("request timed out", FailureKind.TIMEOUT),
            ("connection reset by peer", FailureKind.CONNECTION),
            ("Temporary failure in name resolution", FailureKind.CONNECTION),
            ("503 Service Unavailable", FailureKind.UNAVAILABLE),
            ("backend error, try again later", FailureKind.UNAVAILABLE),
            ("ERROR: permission denied on project", FailureKind.AUTH),
            ("401 Unauthorized", FailureKind.AUTH),
            ("404: job does not exist", FailureKind.NOT_FOUND),
            ("INVALID_ARGUMENT: bad topology", FailureKind.INVALID),
            ("segfault in the flux capacitor", FailureKind.UNKNOWN),
            ("", FailureKind.UNKNOWN),
        ],
    )
    def test_text_table(self, text, kind):
        assert classify_text(text) is kind

    def test_throttling_with_403_is_transient_not_auth(self):
        # ordered table: RATE_LIMIT is checked before AUTH so gcloud's
        # "403 rate limit exceeded" wording classifies retryable
        assert classify_text("403 rate limit exceeded for project") is (
            FailureKind.RATE_LIMIT
        )
        assert classify_text("403 Forbidden") is FailureKind.AUTH

    def test_proc_success_is_none(self):
        assert classify_proc(proc(0)) is None

    def test_proc_stderr_and_stdout_fallback(self):
        assert classify_proc(proc(1, stderr="quota exceeded")) is FailureKind.QUOTA
        # some gcloud verbs print the error on stdout
        assert classify_proc(proc(1, stdout="503 unavailable")) is (
            FailureKind.UNAVAILABLE
        )
        assert classify_proc(proc(1, stderr="boom")) is FailureKind.UNKNOWN

    def test_exception_taxonomy_kind_wins(self):
        e = TransientSchedulerError("x", kind=FailureKind.QUOTA)
        assert classify_exception(e) is FailureKind.QUOTA

    def test_exception_structural(self):
        assert classify_exception(
            subprocess.TimeoutExpired(cmd="gcloud", timeout=5)
        ) is FailureKind.TIMEOUT
        assert classify_exception(ConnectionResetError()) is FailureKind.CONNECTION
        assert classify_exception(TimeoutError()) is FailureKind.TIMEOUT

    def test_exception_status_attribute(self):
        class ApiException(Exception):
            status = 429

        assert classify_exception(ApiException("throttled")) is (
            FailureKind.RATE_LIMIT
        )

        class CodeError(Exception):
            code = 503

        assert classify_exception(CodeError()) is FailureKind.UNAVAILABLE

    def test_exception_typename_without_sdk_import(self):
        class NotFound(Exception):
            pass

        class ServiceUnavailable(Exception):
            pass

        assert classify_exception(NotFound("job gone")) is FailureKind.NOT_FOUND
        assert classify_exception(ServiceUnavailable()) is FailureKind.UNAVAILABLE

    def test_exception_message_fallback(self):
        assert classify_exception(
            RuntimeError("connection refused by endpoint")
        ) is FailureKind.CONNECTION
        assert classify_exception(RuntimeError("???")) is FailureKind.UNKNOWN

    def test_transient_split(self):
        for kind in (
            FailureKind.TIMEOUT,
            FailureKind.RATE_LIMIT,
            FailureKind.QUOTA,
            FailureKind.UNAVAILABLE,
            FailureKind.CONNECTION,
        ):
            assert is_transient(kind)
        for kind in (
            FailureKind.AUTH,
            FailureKind.NOT_FOUND,
            FailureKind.INVALID,
            FailureKind.UNKNOWN,
        ):
            assert not is_transient(kind)


# -- CallPolicy ------------------------------------------------------------


class TestCallPolicy:
    def test_defaults(self):
        p = CallPolicy()
        assert p.retries_for(FailureKind.UNAVAILABLE) == 2
        assert p.retries_for(FailureKind.RATE_LIMIT) == 3
        assert p.retries_for(FailureKind.TIMEOUT) == 1

    def test_permanent_kinds_never_retried(self):
        # even an explicit budget for a permanent kind is hard-zeroed
        p = CallPolicy(retries={FailureKind.AUTH: 5})
        assert p.retries_for(FailureKind.AUTH) == 0
        assert p.retries_for(FailureKind.UNKNOWN) == 0

    def test_missing_kind_is_zero(self):
        p = CallPolicy(retries={})
        assert p.retries_for(FailureKind.UNAVAILABLE) == 0

    def test_non_idempotent_policy_retries_nothing(self):
        for kind in FailureKind:
            assert NON_IDEMPOTENT.retries_for(kind) == 0

    def test_backoff_grows_and_caps(self):
        p = CallPolicy(
            backoff_seconds=1.0,
            backoff_factor=2.0,
            backoff_max_seconds=4.0,
            jitter=0.0,
        )
        assert [p.backoff_delay(n) for n in (1, 2, 3, 4)] == [1.0, 2.0, 4.0, 4.0]

    def test_jitter_bounds(self):
        p = CallPolicy(backoff_seconds=10.0, jitter=0.5)
        rng = random.Random(7)
        for _ in range(50):
            assert 5.0 <= p.backoff_delay(1, rng=rng) <= 15.0

    @pytest.mark.parametrize(
        "kwargs",
        [
            dict(timeout=0),
            dict(timeout=-1),
            dict(backoff_seconds=-1),
            dict(backoff_factor=0.5),
            dict(jitter=1.0),
            dict(jitter=-0.1),
            dict(retries={FailureKind.QUOTA: -1}),
        ],
    )
    def test_validation(self, kwargs):
        with pytest.raises(ValueError):
            CallPolicy(**kwargs)

    def test_retry_number_is_one_based(self):
        with pytest.raises(ValueError):
            CallPolicy().backoff_delay(0)


# -- CircuitBreaker --------------------------------------------------------


class FakeClock:
    def __init__(self):
        self.now = 0.0

    def __call__(self) -> float:
        return self.now


class TestCircuitBreaker:
    def make(self, **kwargs):
        clock = FakeClock()
        defaults = dict(trip_after=3, cooldown_seconds=10.0, clock=clock)
        defaults.update(kwargs)
        return CircuitBreaker("test", **defaults), clock

    def test_trips_after_consecutive_failures(self):
        b, _ = self.make()
        for _ in range(2):
            b.record_failure()
        assert b.state is BreakerState.CLOSED
        b.record_failure()
        assert b.state is BreakerState.OPEN
        assert not b.allow()

    def test_success_resets_the_streak(self):
        b, _ = self.make()
        b.record_failure()
        b.record_failure()
        b.record_success()
        b.record_failure()
        b.record_failure()
        assert b.state is BreakerState.CLOSED

    def test_cooldown_decays_to_half_open_and_admits_one_probe(self):
        b, clock = self.make()
        for _ in range(3):
            b.record_failure()
        clock.now = 9.9
        assert not b.allow()
        clock.now = 10.0
        assert b.state is BreakerState.HALF_OPEN
        assert b.allow()  # the probe
        assert not b.allow()  # only one probe at a time

    def test_probe_success_closes(self):
        b, clock = self.make()
        for _ in range(3):
            b.record_failure()
        clock.now = 10.0
        assert b.allow()
        b.record_success()
        assert b.state is BreakerState.CLOSED
        assert b.allow()

    def test_probe_failure_reopens_immediately(self):
        b, clock = self.make()
        for _ in range(3):
            b.record_failure()
        clock.now = 10.0
        assert b.allow()
        b.record_failure()  # one probe failure trips, not trip_after
        assert b.state is BreakerState.OPEN
        assert not b.allow()

    def test_abandoned_probe_does_not_wedge(self):
        # the prober dies without reporting; the cool-down restarted at
        # probe admission, so another probe is admitted one cool-down later
        b, clock = self.make()
        for _ in range(3):
            b.record_failure()
        clock.now = 10.0
        assert b.allow()
        clock.now = 20.0
        assert b.allow()

    def test_validation(self):
        with pytest.raises(ValueError):
            CircuitBreaker("x", trip_after=0)
        with pytest.raises(ValueError):
            CircuitBreaker("x", cooldown_seconds=-1)


class TestFailureLedger:
    def test_note_count_clear(self, tmp_path):
        led = FailureLedger(str(tmp_path / "fails"), threshold=2)
        assert led.failures() == {}
        led.note("a|b", ok=False)
        led.note("a|b", ok=False)
        led.note("c|d", ok=False)
        assert led.failures() == {"a|b": 2, "c|d": 1}
        assert led.tripped() == {"a|b"}
        led.note("a|b", ok=True)  # success clears only that key
        assert led.failures() == {"c|d": 1}
        assert led.tripped() == set()

    def test_success_without_failures_is_noop(self, tmp_path):
        path = tmp_path / "fails"
        led = FailureLedger(str(path), threshold=1)
        led.note("k", ok=True)
        assert not path.exists()

    def test_clear_is_an_append_only_tombstone(self, tmp_path):
        path = tmp_path / "fails"
        led = FailureLedger(str(path), threshold=1)
        led.note("k", ok=False)
        led.note("k", ok=True)
        # the success appended a tombstone; nothing was rewritten away
        assert path.read_text() == "k\nk|clear\n"
        assert led.failures() == {}
        # a failure landing AFTER the tombstone survives it (the rewrite
        # implementation could drop such a line racing the replace)
        led.note("k", ok=False)
        assert led.failures() == {"k": 1}
        assert led.tripped() == {"k"}

    def test_tombstone_only_clears_earlier_lines(self, tmp_path):
        path = tmp_path / "fails"
        with open(path, "w") as f:
            f.write("a|b\na|b|clear\na|b\nc|d\n")
        led = FailureLedger(str(path), threshold=1)
        assert led.failures() == {"a|b": 1, "c|d": 1}

    def test_validation(self):
        with pytest.raises(ValueError):
            FailureLedger("x", threshold=0)


# -- fault plans -----------------------------------------------------------


class TestFaultPlan:
    def test_parse_inline_list(self):
        plan = FaultPlan.parse(
            '[{"backend": "local", "op": "describe", "nth": 2, "times": 2}]'
        )
        assert len(plan.rules) == 1
        rule = plan.rules[0]
        assert (rule.backend, rule.op, rule.nth, rule.times) == (
            "local",
            "describe",
            2,
            2,
        )
        assert rule.mode == "transient"

    def test_parse_rules_object(self):
        plan = FaultPlan.parse('{"rules": [{"op": "submit", "mode": "timeout"}]}')
        assert plan.rules[0].mode == "timeout"

    def test_parse_file(self, tmp_path):
        f = tmp_path / "plan.json"
        f.write_text('[{"backend": "gke", "mode": "garbage"}]')
        plan = FaultPlan.parse(str(f))
        assert plan.rules[0].backend == "gke"

    @pytest.mark.parametrize(
        "raw",
        [
            "not json at all {",
            '"just a string"',
            '[{"backend": "x", "typo_key": 1}]',
            '[{"mode": "explode"}]',
            '[{"nth": 0}]',
            '[{"times": 0}]',
            "[42]",
        ],
    )
    def test_malformed_plans_fail_loudly(self, raw):
        with pytest.raises(ValueError):
            FaultPlan.parse(raw)

    def test_rule_matching_is_deterministic(self):
        rule = FaultRule(backend="loc*", op="describe", nth=2, times=2)
        fires = [rule.matches("local", "describe", n) for n in range(1, 6)]
        assert fires == [False, True, True, False, False]
        assert not rule.matches("gke", "describe", 2)
        assert not rule.matches("local", "submit", 2)

    def test_nth_omitted_fires_from_first_call(self):
        rule = FaultRule(times=3)
        assert [rule.matches("b", "o", n) for n in (1, 2, 3, 4)] == [
            True,
            True,
            True,
            False,
        ]

    def test_injector_counts_per_backend_op(self):
        plan = FaultPlan(rules=[FaultRule(backend="local", op="describe", nth=2)])
        inj = FaultInjector(plan)
        assert inj.check("local", "describe") is None  # call 1
        assert inj.check("local", "submit") is None  # independent counter
        assert inj.check("local", "describe") is not None  # call 2 fires
        assert inj.check("local", "describe") is None  # call 3

    def test_fire_modes(self):
        inj = FaultInjector(FaultPlan())
        with pytest.raises(TransientSchedulerError) as ei:
            inj.fire(FaultRule(mode="transient"), "b", "o")
        assert ei.value.kind is FailureKind.UNAVAILABLE
        with pytest.raises(PermanentSchedulerError):
            inj.fire(FaultRule(mode="permanent"), "b", "o")
        with pytest.raises(subprocess.TimeoutExpired):
            inj.fire(FaultRule(mode="timeout"), "b", "o")
        assert inj.fire(FaultRule(mode="garbage"), "b", "o") == GARBAGE_PAYLOAD

    def test_active_injector_cached_while_env_unchanged(self, monkeypatch):
        monkeypatch.setenv(
            settings.ENV_TPX_FAULT_PLAN, '[{"backend": "x", "nth": 1}]'
        )
        first = resilience_faults.active_injector()
        assert first is resilience_faults.active_injector()  # counters persist
        monkeypatch.setenv(settings.ENV_TPX_FAULT_PLAN, '[{"backend": "y"}]')
        assert resilience_faults.active_injector() is not first
        monkeypatch.delenv(settings.ENV_TPX_FAULT_PLAN)
        assert resilience_faults.active_injector() is None

    def test_fault_plan_active(self, monkeypatch):
        monkeypatch.delenv(settings.ENV_TPX_FAULT_PLAN, raising=False)
        assert not fault_plan_active()
        monkeypatch.setenv(settings.ENV_TPX_FAULT_PLAN, "[]")
        assert fault_plan_active()


# -- control-plane timeout knob --------------------------------------------


class TestControlPlaneTimeout:
    def test_default(self, monkeypatch):
        monkeypatch.delenv(settings.ENV_TPX_CONTROL_PLANE_TIMEOUT, raising=False)
        assert control_plane_timeout() == settings.DEFAULT_CONTROL_PLANE_TIMEOUT

    @pytest.mark.parametrize("raw", ["0", "off", "none", "NONE", "false", "-5"])
    def test_disabled(self, monkeypatch, raw):
        monkeypatch.setenv(settings.ENV_TPX_CONTROL_PLANE_TIMEOUT, raw)
        assert control_plane_timeout() is None

    def test_explicit_value(self, monkeypatch):
        monkeypatch.setenv(settings.ENV_TPX_CONTROL_PLANE_TIMEOUT, "12.5")
        assert control_plane_timeout() == 12.5

    def test_unparseable_falls_back_to_default(self, monkeypatch):
        monkeypatch.setenv(settings.ENV_TPX_CONTROL_PLANE_TIMEOUT, "soon")
        assert control_plane_timeout() == settings.DEFAULT_CONTROL_PLANE_TIMEOUT


# -- resilient_call --------------------------------------------------------


class TestResilientCall:
    def test_success_passthrough(self):
        before = obs_metrics.CONTROL_PLANE_CALLS.value(
            backend="tc1", op="describe", status="ok"
        )
        assert (
            resilient_call(lambda: 42, backend="tc1", op="describe") == 42
        )
        after = obs_metrics.CONTROL_PLANE_CALLS.value(
            backend="tc1", op="describe", status="ok"
        )
        assert after == before + 1

    def test_transient_retried_then_succeeds(self):
        calls = {"n": 0}
        sleeps: list[float] = []

        def fn():
            calls["n"] += 1
            if calls["n"] <= 2:
                raise TransientSchedulerError("x", kind=FailureKind.UNAVAILABLE)
            return "ok"

        result = resilient_call(
            fn,
            backend="tc2",
            op="describe",
            policy=fast_call_policy(),
            sleep=sleeps.append,
        )
        assert result == "ok"
        assert calls["n"] == 3
        assert len(sleeps) == 2

    def test_budget_exhausted_reraises_the_original(self):
        original = TransientSchedulerError("x", kind=FailureKind.UNAVAILABLE)

        def fn():
            raise original

        with pytest.raises(TransientSchedulerError) as ei:
            resilient_call(
                fn,
                backend="tc3",
                op="describe",
                policy=fast_call_policy(
                    retries={FailureKind.UNAVAILABLE: 1}
                ),
                sleep=lambda s: None,
            )
        assert ei.value is original  # identity: callers' except clauses work

    def test_permanent_raises_immediately_without_retry(self):
        sleeps: list[float] = []

        class NotFound(Exception):
            pass

        def fn():
            raise NotFound("gone")

        with pytest.raises(NotFound):
            resilient_call(
                fn, backend="tc4", op="describe", sleep=sleeps.append
            )
        assert sleeps == []
        # a permanent answer proves the backend reachable
        assert breaker_for("tc4").state is BreakerState.CLOSED

    def test_breaker_opens_and_rejects(self):
        def fn():
            raise TransientSchedulerError("x", kind=FailureKind.UNAVAILABLE)

        policy = fast_call_policy(retries={})
        for _ in range(5):  # default trip_after
            with pytest.raises(TransientSchedulerError):
                resilient_call(
                    fn, backend="tc5", op="describe", policy=policy,
                    sleep=lambda s: None,
                )
        assert breaker_for("tc5").state is BreakerState.OPEN
        before = obs_metrics.CONTROL_PLANE_CALLS.value(
            backend="tc5", op="describe", status="rejected"
        )
        with pytest.raises(BreakerOpenError):
            resilient_call(lambda: 1, backend="tc5", op="describe")
        after = obs_metrics.CONTROL_PLANE_CALLS.value(
            backend="tc5", op="describe", status="rejected"
        )
        assert after == before + 1
        # BreakerOpenError itself classifies transient (UNAVAILABLE), so
        # poll loops absorb it under their miss budget
        assert is_transient(classify_exception(BreakerOpenError("x")))


# -- resilient_cmd ---------------------------------------------------------


class TestResilientCmd:
    def test_default_deadline_injected(self, monkeypatch):
        monkeypatch.delenv(settings.ENV_TPX_CONTROL_PLANE_TIMEOUT, raising=False)
        seen = {}

        def run(cmd, **kwargs):
            seen.update(kwargs)
            return proc(0)

        resilient_cmd(run, ["x"], backend="cm1", op="describe")
        assert seen["timeout"] == settings.DEFAULT_CONTROL_PLANE_TIMEOUT

    def test_caller_timeout_wins(self):
        seen = {}

        def run(cmd, **kwargs):
            seen.update(kwargs)
            return proc(0)

        resilient_cmd(run, ["x"], backend="cm1", op="describe", timeout=7)
        assert seen["timeout"] == 7

    def test_disabled_deadline_means_no_timeout_kwarg(self, monkeypatch):
        monkeypatch.setenv(settings.ENV_TPX_CONTROL_PLANE_TIMEOUT, "off")
        seen = {"called": False}

        def run(cmd, **kwargs):
            seen["called"] = True
            assert "timeout" not in kwargs
            return proc(0)

        resilient_cmd(run, ["x"], backend="cm1", op="describe")
        assert seen["called"]

    def test_transient_exit_retried_then_succeeds(self):
        procs = [proc(1, stderr="503 unavailable"), proc(0, stdout="done")]
        sleeps: list[float] = []

        result = resilient_cmd(
            lambda cmd, **kw: procs.pop(0),
            ["x"],
            backend="cm2",
            op="describe",
            policy=fast_call_policy(),
            sleep=sleeps.append,
        )
        assert result.returncode == 0
        assert result.stdout == "done"
        assert len(sleeps) == 1

    def test_budget_exhausted_returns_last_failing_proc(self):
        last = proc(1, stderr="too many requests")
        sleeps: list[float] = []

        result = resilient_cmd(
            lambda cmd, **kw: last,
            ["x"],
            backend="cm3",
            op="describe",
            policy=fast_call_policy(retries={FailureKind.RATE_LIMIT: 2}),
            sleep=sleeps.append,
        )
        assert result is last  # returned, never raised: rc semantics hold
        assert len(sleeps) == 2

    def test_permanent_exit_returned_without_retry(self):
        sleeps: list[float] = []
        result = resilient_cmd(
            lambda cmd, **kw: proc(1, stderr="permission denied"),
            ["x"],
            backend="cm4",
            op="describe",
            policy=fast_call_policy(),
            sleep=sleeps.append,
        )
        assert result.returncode == 1
        assert sleeps == []
        assert breaker_for("cm4").state is BreakerState.CLOSED

    def test_hung_call_synthesizes_timeout_proc(self):
        def run(cmd, **kwargs):
            raise subprocess.TimeoutExpired(cmd=cmd, timeout=kwargs["timeout"])

        sleeps: list[float] = []
        result = resilient_cmd(
            run,
            ["x"],
            backend="cm5",
            op="describe",
            policy=fast_call_policy(retries={FailureKind.TIMEOUT: 1}),
            sleep=sleeps.append,
            timeout=0.5,
        )
        assert result.returncode == TIMEOUT_RETURNCODE
        assert settings.ENV_TPX_CONTROL_PLANE_TIMEOUT in result.stderr
        assert len(sleeps) == 1  # retried once, then degraded to a proc

    def test_garbage_fault_returns_unparseable_stdout(self, monkeypatch):
        monkeypatch.setenv(
            settings.ENV_TPX_FAULT_PLAN,
            '[{"backend": "cm6", "op": "list", "mode": "garbage"}]',
        )
        calls = {"n": 0}

        def run(cmd, **kwargs):
            calls["n"] += 1
            return proc(0, stdout="real output")

        result = resilient_cmd(run, ["x"], backend="cm6", op="list")
        assert calls["n"] == 0  # the real call never happened
        assert result.returncode == 0
        assert result.stdout == GARBAGE_PAYLOAD



# -- parity with the JAX package -------------------------------------------

#: fragments the seeded classifier inputs are drawn from: every table row's
#: wording, near misses, and noise
_FRAGMENTS = (
    "HTTP 429", "Too Many Requests", "rate limit exceeded", "403", "Forbidden",
    "Quota exceeded for quota metric 'GPUS'", "RESOURCE_EXHAUSTED", "out of capacity",
    "DEADLINE_EXCEEDED", "request timed out", "timeout", "connection reset by peer",
    "Temporary failure in name resolution", "connection refused", "503",
    "Service Unavailable", "backend error, try again later", "permission denied",
    "401 Unauthorized", "404", "does not exist", "not found", "INVALID_ARGUMENT",
    "bad topology", "segfault", "ERROR:", "while polling operation", "",
)


def _texts(seed: int, n: int = 300) -> list[str]:
    rng = random.Random(seed)
    return [" ".join(rng.sample(_FRAGMENTS, rng.randint(0, 3))) for _ in range(n)]


def _exceptions(seed: int) -> list[BaseException]:
    """The same exceptions for both packages' classifiers: structural,
    status-coded, SDK-named and message-only ones, and the
    CalledProcessErrors a subprocess seam raises."""
    rng = random.Random(seed)
    out: list[BaseException] = [
        subprocess.TimeoutExpired(cmd="gcloud", timeout=5), ConnectionResetError(),
        ConnectionRefusedError(), TimeoutError(), BrokenPipeError(), OSError("disk"),
        ValueError("bad"), KeyError("k"),
    ]
    for text in _texts(seed, 60):
        out.append(RuntimeError(text))
        out.append(subprocess.CalledProcessError(rng.randint(1, 255), ["kubectl"],
                                                 output=text, stderr=text[::-1]))
    for status in (400, 401, 403, 404, 408, 409, 429, 500, 502, 503, 504, 599):
        out.append(type("ApiException", (Exception,), {"status": status})("x"))
        out.append(type("CodeError", (Exception,), {"code": status})())
    for name in ("NotFound", "ServiceUnavailable", "TooManyRequests", "Forbidden",
                 "PermissionDenied", "DeadlineExceeded", "InternalServerError",
                 "ResourceExhausted", "Unauthenticated", "InvalidArgument", "Conflict"):
        out.append(type(name, (Exception,), {})("gone"))
    return out


class TestParityWithJax:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_text_and_proc_kinds(self, seed):
        texts = _texts(seed)
        assert [classify_text(t).value for t in texts] == \
            [jres.classify_text(t).value for t in texts]
        rng = random.Random(seed)
        for text in texts:
            p = proc(rng.choice([0, 1, 2, 124, 255]), **{rng.choice(["stderr", "stdout"]): text})
            got, want = classify_proc(p), jres.classify_proc(p)
            assert (got and got.value) == (want and want.value), text

    @pytest.mark.parametrize("seed", [0, 1])
    def test_exception_kinds(self, seed):
        excs = _exceptions(seed)
        assert [classify_exception(e).value for e in excs] == \
            [jres.classify_exception(e).value for e in excs]
        # the taxonomy's own errors, each package's for its own classifier
        for kind in FailureKind:
            jkind = jres.FailureKind(kind.value)
            assert classify_exception(TransientSchedulerError("x", kind=kind)) is kind
            assert jres.classify_exception(jres.TransientSchedulerError("x", kind=jkind)) \
                is jkind
        assert is_transient(classify_exception(BreakerOpenError("x"))) == \
            jres.is_transient(jres.classify_exception(jres.BreakerOpenError("x")))
        assert sorted(k.value for k in FailureKind if is_transient(k)) == \
            sorted(k.value for k in jres.FailureKind if jres.is_transient(k))

    @pytest.mark.parametrize("seed", [3, 11])
    def test_backoff_sequence_under_one_seed(self, seed):
        kwargs = dict(backoff_seconds=0.5, backoff_factor=1.7, backoff_max_seconds=6.0,
                      jitter=0.4)
        ours, theirs = CallPolicy(**kwargs), jres.CallPolicy(**kwargs)
        r1, r2 = random.Random(seed), random.Random(seed)
        assert [ours.backoff_delay(n, rng=r1) for n in range(1, 12)] == \
            [theirs.backoff_delay(n, rng=r2) for n in range(1, 12)]
        assert {k.value: ours.retries_for(k) for k in FailureKind} == \
            {k.value: theirs.retries_for(jres.FailureKind(k.value))
             for k in jres.FailureKind}

    @pytest.mark.parametrize("plan", [
        '[{"backend": "par*", "op": "describe", "nth": 2, "times": 2}]',
        '[{"backend": "parity", "op": "describe", "mode": "timeout", "times": 1}]',
        '[{"backend": "parity", "op": "describe", "mode": "permanent", "nth": 2}]',
        '[{"op": "describe", "times": 9}]',
        '[{"backend": "parity", "mode": "garbage"}]',
    ])
    def test_resilient_call_under_one_fault_plan(self, plan, monkeypatch):
        """Attempts, sleeps, outcome and metric increments of ten calls, the
        same in both packages under one ``TPX_FAULT_PLAN``."""
        monkeypatch.setenv(settings.ENV_TPX_FAULT_PLAN, plan)

        def run(res, cmod, fmod, metrics):
            fmod.reset()
            cmod.reset_breakers()
            backend = "parity"
            calls, sleeps, outcomes = [0], [], []
            counters = {
                "calls": lambda s: metrics.CONTROL_PLANE_CALLS.value(
                    backend=backend, op="describe", status=s),
                "retries": lambda k: metrics.CONTROL_PLANE_RETRIES.value(
                    backend=backend, op="describe", kind=k),
            }
            statuses, kinds = ("ok", "error", "rejected"), [k.value for k in res.FailureKind]
            before = ([counters["calls"](s) for s in statuses],
                      [counters["retries"](k) for k in kinds])

            def fn():
                calls[0] += 1
                return calls[0]

            policy = res.CallPolicy(backoff_seconds=0.25, jitter=0.5)
            rng = random.Random(5)
            for _ in range(10):
                try:
                    outcomes.append(("ok", cmod.resilient_call(
                        fn, backend=backend, op="describe", policy=policy,
                        sleep=sleeps.append, rng=rng)))
                except Exception as e:  # noqa: BLE001 - the outcome is compared
                    outcomes.append((type(e).__name__, res.classify_exception(e).value))
            after = ([counters["calls"](s) for s in statuses],
                     [counters["retries"](k) for k in kinds])
            deltas = ([a - b for a, b in zip(after[0], before[0])],
                      [a - b for a, b in zip(after[1], before[1])])
            return calls[0], sleeps, outcomes, deltas, cmod.breaker_for(backend).state.value

        ours = run(tres, tcall, resilience_faults, obs_metrics)
        theirs = run(jres, jcall, jfaults, jmetrics)
        assert ours == theirs
        # every plan injected something: a retry, a sleep or a failed call
        assert ours[1] or any(o[0] != "ok" or o[1] != i for i, o in enumerate(ours[2], 1))
        resilience_faults.reset()
        jfaults.reset()
