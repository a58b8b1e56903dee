"""Per-tenant SLO accounting: good/bad events -> multi-window burn rates.

Port of ``cylon_tpu/serve/slo.py`` on the port's
:class:`~cylon_tpu_torch.telemetry.timeseries.BurnRate`. The engine
enforces per-request SLOs (the watchdog deadline fails a request that
blows its budget); this module ACCOUNTS for them, the SRE-workbook
recipe over the shared windowed machinery:

* every request retirement is classified **good** (completed without
  error AND — when a latency objective is set — within ``slo_latency``
  seconds) or **bad** (error, expiry, or too slow);
* each tenant accumulates good/bad counts in one
  :class:`~cylon_tpu_torch.telemetry.timeseries.BurnRate` — a pair of
  sliding :class:`~cylon_tpu_torch.telemetry.timeseries.EventWindow`
  rings per configured window;
* after every retirement the current burn rate lands on the
  ``serve.slo_burn{tenant=,window=}`` gauge — scrapeable from
  ``/metrics``, windowed-viewable from ``/metrics/window``, and read
  directly by the ``/health`` verdict.

``burn = bad_fraction / (1 - objective)``: 1.0 means the tenant is
consuming its error budget exactly at the sustainable pace; the
``/health`` verdict flags ``burn >= 1`` as degraded and
``burn >= ServePolicy.burn_critical`` as unhealthy.

Disabled (the default — ``slo_target`` unset) this module allocates
nothing and :meth:`SloTracker.record` returns after one attribute read.
"""

import threading

from cylon_tpu_torch import telemetry
from cylon_tpu_torch.telemetry.timeseries import BurnRate

__all__ = ["SloTracker"]


class SloTracker:
    """Good/bad retirement accounting per tenant (module docstring; port
    of ``cylon_tpu/serve/slo.py`` ``SloTracker``).

    Built from a :class:`~cylon_tpu_torch.serve.admission.ServePolicy`:
    ``slo_target`` (the success objective, e.g. ``0.99``) arms it;
    ``slo_latency`` (seconds) optionally tightens "good" to "fast
    enough"; ``slo_windows`` are the burn windows (short first)."""

    def __init__(self, policy):
        self.objective = policy.slo_target
        self.latency_s = policy.slo_latency
        self.windows = tuple(policy.slo_windows)
        self._mu = threading.Lock()
        self._tenants: "dict[str, BurnRate]" = {}

    @property
    def enabled(self) -> bool:
        return self.objective is not None

    def record(self, tenant: str, ok: bool,
               latency_s: "float | None") -> None:
        """Classify one retirement and refresh the tenant's burn
        gauges. No-op (one attribute read) when no objective is set."""
        if self.objective is None:
            return
        good = bool(ok)
        if (good and self.latency_s is not None
                and latency_s is not None
                and latency_s > self.latency_s):
            good = False  # completed, but too slow to count as good
        tenant = str(tenant)
        with self._mu:
            br = self._tenants.get(tenant)
            if br is None:
                br = self._tenants[tenant] = BurnRate(
                    self.objective, self.windows)
            br.record(good)
            burns = br.burns()
        for w, b in burns.items():
            if b is not None:
                telemetry.gauge("serve.slo_burn", tenant=tenant,
                                window=_wlabel(w)).set(round(b, 4))

    def burn_rates(self) -> "dict[str, dict]":
        """``{tenant: {window_s: burn | None}}`` recomputed from the
        live windows (an idle tenant's burn decays to None as its
        events age out — gauges keep the last written value, this is
        the fresh read ``/health`` uses). Reads INSIDE the tracker
        lock: EventWindow is caller-locked by contract, and a /health
        poll racing the scheduler's record() on the same deques would
        otherwise corrupt counts (or IndexError mid-evict)."""
        with self._mu:
            return {t: br.burns() for t, br in self._tenants.items()}

    def worst(self) -> "tuple[str, float, float] | None":
        """The worst (tenant, window_s, burn) right now, or None when
        no tenant has events in any window."""
        worst = None
        for tenant, burns in self.burn_rates().items():
            for w, b in burns.items():
                if b is None:
                    continue
                if worst is None or b > worst[2]:
                    worst = (tenant, w, b)
        return worst


def _wlabel(window_s: float) -> str:
    """Stable label for a window length (``60s``, ``300s`` — trailing
    zeros trimmed so 60.0 and 60 key the same series)."""
    w = float(window_s)
    return f"{int(w)}s" if w == int(w) else f"{w}s"
