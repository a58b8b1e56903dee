"""Admission control for the always-on engine: load-shed fast, never
pile up.

Port of ``cylon_tpu/serve/admission.py`` on the port's telemetry
(:class:`~cylon_tpu_torch.telemetry.timeseries.EventWindow` for the
breaker's failure window). An engine that accepts every request under
overload turns one slow query into unbounded queue growth, memory
pressure and a p99 that never recovers; this module adopts gRPC's
RESOURCE_EXHAUSTED discipline:

* a **queue-depth cap** (``max_queue``) on live (queued + running)
  requests — a submit over the cap raises
  :class:`~cylon_tpu_torch.errors.ResourceExhausted` *immediately* (a
  dict check under one lock, no device work, no blocking);
* a **circuit breaker** (:class:`CircuitBreaker`): under a sustained
  storm of ``DeadlineExceeded``/``ResourceExhausted`` request failures
  the engine stops admitting NEW work — fast rejection, counted as
  ``serve.shed{reason="breaker"}`` — while in-flight requests keep
  draining on the scheduler. After ``breaker_cooldown`` seconds the
  breaker half-opens and admissions probe through again;
* a **default SLO** (``default_slo``) stamped on every admitted request
  that doesn't bring its own — the per-request
  :func:`cylon_tpu_torch.watchdog.deadline` budget the scheduler
  enforces at every step;
* the **schedule policy** (``roundrobin`` fair-share default, or
  ``priority`` weighted by tenant priority) the scheduler drives through
  the :mod:`cylon_tpu_torch.ops_graph.execution` strategies.

:class:`ServePolicy` is the interface: the engine takes one, and
:func:`default_policy` returns its documented defaults (``max_queue``
64, no default SLO, ``roundrobin``, breaker 5 failures in 30 s with a
5 s cooldown, no memory budget, SLO accounting off, burn windows 60 s
and 300 s, critical burn 10). The JAX package also reads each knob from
a ``CYLON_TPU_SERVE_*`` variable; nothing in the port sets them, so the
port reads none.

Two admission *bypasses* ride in front of this module: a versioned
result-cache hit and a coalesced attach to an identical in-flight
request. Neither takes an admission slot, feeds the breaker, nor
observes ``serve.queue_wait_seconds``. The split is labeled
``serve.admitted{path=executed|cache_hit|coalesced}``.
"""

import dataclasses
import threading
import time

from cylon_tpu_torch import telemetry
from cylon_tpu_torch.errors import InvalidArgument, ResourceExhausted
from cylon_tpu_torch.telemetry import events as _events
from cylon_tpu_torch.telemetry.timeseries import EventWindow

__all__ = ["ServePolicy", "default_policy", "AdmissionController",
           "CircuitBreaker"]

_SCHEDULES = ("roundrobin", "priority")


@dataclasses.dataclass(frozen=True)
class ServePolicy:
    """Engine-level admission/scheduling knobs (see module docstring;
    port of ``cylon_tpu/serve/admission.py`` ``ServePolicy``)."""

    max_queue: int = 64
    default_slo: "float | None" = None
    schedule: str = "roundrobin"
    breaker_fails: int = 5
    breaker_window: float = 30.0
    breaker_cooldown: float = 5.0
    #: memory-aware admission (bytes; None/0 disables): a submit whose
    #: ``predicted_bytes`` exceeds this budget sheds immediately with
    #: ``serve.shed{reason="memory"}`` — the front-door twin of the
    #: OOM→spill fallback's pre-flight
    memory_budget: "int | None" = None
    #: SLO burn-rate accounting (None disables — the
    #: default, so an unarmed engine allocates no windows): the
    #: per-tenant SUCCESS objective (e.g. 0.99 = 1% error budget)
    #: retirements are scored against
    slo_target: "float | None" = None
    #: latency objective (seconds; None = success-only SLO): a request
    #: that completes but slower than this counts BAD toward the burn
    slo_latency: "float | None" = None
    #: burn windows (seconds, short first): the multi-window pair the
    #: SRE recipe reads together — short for fast detection, long for
    #: de-flapping
    slo_windows: "tuple" = (60.0, 300.0)
    #: burn rate at which the /health verdict flags a tenant's SLO as
    #: unhealthy (>= 1 is already "burning too fast"; this is the
    #: page-now threshold)
    burn_critical: float = 10.0

    def __post_init__(self):
        if self.max_queue < 1:
            raise InvalidArgument(
                f"max_queue must be >= 1, got {self.max_queue}")
        if self.schedule not in _SCHEDULES:
            raise InvalidArgument(
                f"unknown schedule {self.schedule!r}; valid: "
                f"{_SCHEDULES}")
        if self.default_slo is not None and self.default_slo <= 0:
            raise InvalidArgument(
                f"default_slo must be > 0 seconds or None, got "
                f"{self.default_slo}")
        if self.breaker_fails < 0:
            raise InvalidArgument(
                f"breaker_fails must be >= 0 (0 disables), got "
                f"{self.breaker_fails}")
        if self.breaker_window <= 0 or self.breaker_cooldown <= 0:
            raise InvalidArgument(
                "breaker_window/breaker_cooldown must be > 0 seconds")
        if self.memory_budget is not None and self.memory_budget < 0:
            raise InvalidArgument(
                f"memory_budget must be >= 0 bytes (0/None disables), "
                f"got {self.memory_budget}")
        if self.slo_target is not None and not 0 < self.slo_target < 1:
            raise InvalidArgument(
                f"slo_target must be in (0, 1) or None, got "
                f"{self.slo_target}")
        if self.slo_latency is not None and self.slo_latency <= 0:
            raise InvalidArgument(
                f"slo_latency must be > 0 seconds or None, got "
                f"{self.slo_latency}")
        if not self.slo_windows or \
                any(w <= 0 for w in self.slo_windows):
            raise InvalidArgument(
                f"slo_windows must be non-empty positive seconds, got "
                f"{self.slo_windows}")
        if self.burn_critical <= 0:
            raise InvalidArgument(
                f"burn_critical must be > 0, got {self.burn_critical}")


def default_policy() -> ServePolicy:
    """The documented default :class:`ServePolicy` (port of
    ``cylon_tpu/serve/admission.py`` ``default_policy``, which also
    reads ``CYLON_TPU_SERVE_*`` overrides; the port reads none — pass a
    :class:`ServePolicy` instead)."""
    return ServePolicy()


class CircuitBreaker:
    """Failure-storm gate: open = shed new admissions, drain in-flight
    (port of ``cylon_tpu/serve/admission.py`` ``CircuitBreaker``).

    ``record_failure(kind)`` feeds request retirements whose error
    class signals systemic overload (:data:`BREAKING_KINDS` — SLO
    storms and resource exhaustion, NOT per-request bugs); when
    ``threshold`` such failures land within ``window`` seconds the
    breaker OPENS. While open, :meth:`allow` is False — the admission
    controller sheds with a fast ResourceExhausted — until ``cooldown``
    seconds pass, when the breaker half-opens: the failure ledger
    clears and admissions probe through (a fresh storm re-trips it). A
    success in the closed state clears the ledger — only *sustained*
    storms trip. ``threshold <= 0`` disables the breaker entirely.

    The failure window rides the shared sliding-window machinery
    (:class:`~cylon_tpu_torch.telemetry.timeseries.EventWindow`),
    and the breaker's state is OBSERVABLE instead of private:
    :meth:`snapshot` reports state (``closed``/``open``/``half_open``
    — half-open = cooldown elapsed, next admission probes through),
    cooldown remaining and the windowed failure count; ``/healthz``
    and the ``/health`` verdict both read it, and open/close
    transitions land in the structured event journal
    (``breaker_open``/``breaker_close``)."""

    #: error type names that count toward tripping: the systemic-
    #: overload classes (a deadline storm from a wedged mesh, resource
    #: exhaustion from an HBM cascade). Per-request failures
    #: (InvalidArgument, a query bug) never trip the breaker.
    BREAKING_KINDS = frozenset({"DeadlineExceeded", "ResourceExhausted"})

    def __init__(self, threshold: int = 5, window: float = 30.0,
                 cooldown: float = 5.0):
        self.threshold = int(threshold)
        self.window = float(window)
        self.cooldown = float(cooldown)
        self._mu = threading.Lock()
        #: windowed failure ledger — O(slots) memory however large the
        #: storm (the old deque of timestamps grew with it)
        self._failures = EventWindow(self.window)
        self._opened_at: "float | None" = None

    def _state_locked(self, now: float) -> str:
        if self._opened_at is None:
            return "closed"
        if now - self._opened_at < self.cooldown:
            return "open"
        return "half_open"  # next allow() probes through

    @property
    def state(self) -> str:
        with self._mu:
            return self._state_locked(time.monotonic())

    def snapshot(self) -> dict:
        """Observable breaker state (the ``/healthz`` + ``/health``
        payload): state, seconds of cooldown remaining (0 unless
        open), and the current windowed failure count."""
        now = time.monotonic()
        with self._mu:
            state = self._state_locked(now)
            remaining = (max(self.cooldown - (now - self._opened_at),
                             0.0) if self._opened_at is not None
                         else 0.0)
            failures = self._failures.count(now)
        return {"state": state,
                "cooldown_remaining_s": round(remaining, 3),
                "window_failures": failures,
                "threshold": self.threshold,
                "window_s": self.window,
                "cooldown_s": self.cooldown}

    def record_failure(self, kind: str) -> None:
        if self.threshold <= 0 or kind not in self.BREAKING_KINDS:
            return
        now = time.monotonic()
        with self._mu:
            self._failures.add(1, now=now)
            n = self._failures.count(now)
            if self._opened_at is None and n >= self.threshold:
                self._opened_at = now
                telemetry.counter("serve.breaker_trips").inc()
                telemetry.gauge("serve.breaker_open").set(1)
                tripped = True
            else:
                tripped = False
        if tripped:
            _events.emit("breaker_open", failures=n,
                         window_s=self.window,
                         cooldown_s=self.cooldown)

    def record_success(self) -> None:
        """A completed request in the closed state clears the streak
        (the storm was not sustained)."""
        with self._mu:
            if self._opened_at is None:
                self._failures.clear()

    def allow(self) -> bool:
        """May a new request be admitted right now? Transitions
        open → half-open after ``cooldown`` (ledger cleared, admissions
        probe through)."""
        if self.threshold <= 0:
            return True
        now = time.monotonic()
        with self._mu:
            if self._opened_at is None:
                return True
            if now - self._opened_at < self.cooldown:
                return False
            # half-open: let traffic probe; a fresh storm re-trips
            open_s = now - self._opened_at
            self._opened_at = None
            self._failures.clear()
            telemetry.gauge("serve.breaker_open").set(0)
        _events.emit("breaker_close", open_s=round(open_s, 3))
        return True


class AdmissionController:
    """The queue-depth gate in front of the scheduler (port of
    ``cylon_tpu/serve/admission.py`` ``AdmissionController``).

    ``admit(tenant)`` either takes one live slot or raises
    :class:`~cylon_tpu_torch.errors.ResourceExhausted` naming the depth and
    cap (counted per tenant as ``serve.rejected{tenant=}``); every
    admit is balanced by exactly one ``release()`` when the request
    retires (done, failed, or expired). ``serve.queue_depth`` gauges
    the live count after every transition."""

    def __init__(self, policy: "ServePolicy | None" = None):
        self.policy = policy or default_policy()
        self._mu = threading.Lock()
        self._live = 0
        self.breaker = CircuitBreaker(
            threshold=self.policy.breaker_fails,
            window=self.policy.breaker_window,
            cooldown=self.policy.breaker_cooldown)

    @property
    def live(self) -> int:
        with self._mu:
            return self._live

    def admit(self, tenant: str,
              predicted_bytes: "int | None" = None) -> None:
        budget = self.policy.memory_budget
        if (budget and predicted_bytes is not None
                and predicted_bytes > budget):
            # memory-aware shed: a request PREDICTED not to fit is
            # refused at the front door (microseconds) instead of
            # dying minutes later in an HBM cascade — the admission
            # twin of the fallback executor's pre-flight
            telemetry.counter("serve.shed", reason="memory",
                              tenant=tenant).inc()
            telemetry.counter("serve.rejected", tenant=tenant).inc()
            _events.emit("shed", tenant=tenant, reason="memory")
            raise ResourceExhausted(
                f"predicted memory {predicted_bytes} bytes exceeds "
                f"the serve memory budget {budget} (tenant "
                f"{tenant!r}); shed — submit with a fallback= spill "
                "path, reduce the working set, or raise the policy's "
                "memory_budget")
        if not self.breaker.allow():
            # open breaker: shed BEFORE taking a slot — in-flight work
            # keeps draining, new work is refused in microseconds
            telemetry.counter("serve.shed", reason="breaker",
                              tenant=tenant).inc()
            telemetry.counter("serve.rejected", tenant=tenant).inc()
            _events.emit("shed", tenant=tenant, reason="breaker")
            raise ResourceExhausted(
                f"serve circuit breaker open (sustained "
                f"DeadlineExceeded/ResourceExhausted storm; tenant "
                f"{tenant!r}): shedding new admissions while in-flight "
                f"work drains; retry after "
                f"{self.policy.breaker_cooldown:.1f}s")
        with self._mu:
            if self._live >= self.policy.max_queue:
                depth = self._live
                admitted = False
            else:
                self._live += 1
                depth = self._live
                admitted = True
        telemetry.gauge("serve.queue_depth").set(depth)
        if not admitted:
            telemetry.counter("serve.shed", reason="queue_full",
                              tenant=tenant).inc()
            telemetry.counter("serve.rejected", tenant=tenant).inc()
            _events.emit("shed", tenant=tenant, reason="queue_full")
            raise ResourceExhausted(
                f"serve queue full: {depth} live requests >= cap "
                f"{self.policy.max_queue} (tenant {tenant!r}); "
                "back off and retry")

    def release(self) -> None:
        with self._mu:
            self._live = max(self._live - 1, 0)
            depth = self._live
        telemetry.gauge("serve.queue_depth").set(depth)
