"""Read-only live introspection endpoint for the serve engine.

Port of ``cylon_tpu/serve/introspect.py`` on the port's telemetry. The
ops plane: a stdlib ``http.server`` thread serving a running
:class:`~cylon_tpu_torch.serve.ServeEngine`'s live state as JSON (and
Prometheus text), armed ONLY by ``CYLON_TPU_SERVE_HTTP_PORT`` — the same
no-threads-unless-armed contract as every other telemetry surface: with
the variable unset, :func:`maybe_start` is one env read and returns
None; no socket is bound, no thread starts.

Endpoints (all GET, all read-only):

=========================  ============================================
path                       payload
=========================  ============================================
``/healthz``               liveness: state, live request count,
                           uptime, the breaker's observable state and
                           the shed counts
``/health``                the composite verdict (:func:`health_verdict`):
                           ``{"status": ok|degraded|unhealthy, "score",
                           "reasons": [...], "components": {...}}`` from
                           queue depth vs cap, breaker state, SLO burn
                           rates, free device-memory headroom, recent
                           watchdog expiries and the scheduler's
                           last-step age
``/metrics``               live Prometheus text over a fresh registry
                           snapshot
``/metrics/window``        the sliding-window JSON view
                           (:func:`cylon_tpu_torch.telemetry.timeseries.
                           window_view`) over ``?window=<s>``
``/events``                the structured event journal from
                           ``?since=<cursor>``
``/trace``                 the flight recorder's segment from
                           ``?since=<cursor>`` (``armed: false`` unless
                           ``CYLON_TPU_TRACE`` armed it)
``/queries``               in-flight tickets — tenant, state, elapsed,
                           remaining SLO budget, step count — plus the
                           process's active watchdog sections
``/tenants``               ``ServeEngine.tenant_stats()``
``/tables``                resident catalog: rows/bytes/pins/holders, the
                           per-device byte split and the version column
``/views``                 materialized views: sources, watermarks,
                           digests, refresh counts
``/profiles/<rid>``        one retired-or-live request's ANALYZE profile
                           (``QueryTicket.profile()``)
=========================  ============================================

Binding is loopback-only (``127.0.0.1``); port ``0`` binds an ephemeral
port (tests), the bound address is ``IntrospectServer.address``.

The memory component of ``/health`` reads the card:
:func:`cylon_tpu_torch.fallback.free_hbm_bytes` (free bytes plus the
allocator's unallocated cache) over
:func:`~cylon_tpu_torch.fallback.hbm_limit_bytes` (the card's total).
Without a card both are None and the component is skipped — it never
makes up a denominator. The scheduler counts as stalled after
:data:`STALL_AGE_S` seconds without a step while requests are live (the
JAX package reads ``CYLON_TPU_SERVE_STALL_AGE``, which only its fleet
sets).
"""

import json
import os
import threading
import time
import urllib.parse

__all__ = ["maybe_start", "IntrospectServer", "ENDPOINTS",
           "health_verdict"]

#: the read-only surface (for docs and the landing page)
ENDPOINTS = ("/healthz", "/health", "/metrics", "/metrics/window",
             "/events", "/trace", "/queries", "/tenants", "/tables",
             "/views", "/profiles/<rid>")

#: /health status thresholds over the composite score (1.0 = pristine)
_OK_SCORE = 0.8
_DEGRADED_SCORE = 0.5

#: seconds without a scheduler step, with requests live, after which
#: /health reads the scheduler as stalled
STALL_AGE_S = 10.0


def health_verdict(engine) -> dict:
    """The composite health verdict a router polls (port of
    ``cylon_tpu/serve/introspect.py`` ``health_verdict``).

    Pure read: every component is an existing observable — queue depth
    vs the admission cap, the circuit breaker's
    :meth:`~cylon_tpu_torch.serve.admission.CircuitBreaker.snapshot`,
    per-tenant SLO burn rates (:meth:`ServeEngine.slo_report`),
    free device-memory headroom (the card's free and total bytes), watchdog
    sections expired inside the metric-history window, and the
    scheduler's last-step age. Each finding subtracts a fixed penalty
    from a score starting at 1.0 and appends a human-readable reason;
    ``status`` is ``ok`` (>= 0.8), ``degraded`` (>= 0.5) or
    ``unhealthy`` — the contract being: a router should prefer ``ok``
    engines, deprioritise ``degraded`` ones, and stop routing to
    ``unhealthy`` ones entirely (an open breaker or a wedged scheduler
    alone is enough to get there)."""
    from cylon_tpu_torch import fallback as _fallback
    from cylon_tpu_torch.telemetry import timeseries

    reasons: "list[str]" = []
    components: dict = {}
    score = 1.0
    policy = engine._policy
    adm = engine._admission

    # 1. queue depth vs cap — the front door's remaining capacity
    live, cap = adm.live, policy.max_queue
    ratio = live / cap if cap else 0.0
    components["queue"] = {"live": live, "cap": cap,
                           "ratio": round(ratio, 3)}
    if ratio >= 1.0:
        score -= 0.3
        reasons.append(f"queue_full: {live}/{cap} live requests")
    elif ratio >= 0.8:
        score -= 0.1
        reasons.append(f"queue_pressure: {live}/{cap} live requests")

    # 2. circuit breaker — open means every new submit sheds
    br = adm.breaker.snapshot()
    components["breaker"] = br
    if br["state"] == "open":
        score -= 0.6
        reasons.append(
            f"breaker_open: {br['window_failures']} failure(s) in "
            f"{br['window_s']:.0f}s window, cooldown "
            f"{br['cooldown_remaining_s']:.1f}s remaining")
    elif br["state"] == "half_open":
        score -= 0.15
        reasons.append("breaker_half_open: probing after cooldown")

    # 3. SLO burn — the worst tenant/window pair, read fresh
    slo = engine.slo_report()
    components["slo"] = slo
    worst = slo.get("worst")
    if worst is not None:
        b = worst["burn"]
        if b >= policy.burn_critical:
            score -= 0.5
            reasons.append(
                f"slo_burn: tenant {worst['tenant']!r} burning "
                f"{b:.1f}x its error budget over {worst['window']}")
        elif b >= 1.0:
            score -= 0.15
            reasons.append(
                f"slo_burn_warning: tenant {worst['tenant']!r} at "
                f"{b:.1f}x budget over {worst['window']}")

    # 4. free device-memory headroom (the card's free bytes plus the
    # allocator's unallocated cache, over its total; skipped without a
    # card rather than inventing a denominator)
    free = _fallback.free_hbm_bytes()
    limit = _fallback.hbm_limit_bytes()
    mem = {"free_hbm_bytes": free, "hbm_limit_bytes": limit}
    if free is not None and limit:
        headroom = free / limit
        mem["headroom"] = round(headroom, 4)
        if headroom < 0.02:
            score -= 0.4
            reasons.append(
                f"hbm_exhausted: {headroom:.1%} of {limit} bytes free")
        elif headroom < 0.10:
            score -= 0.15
            reasons.append(
                f"hbm_pressure: {headroom:.1%} of {limit} bytes free")
    components["memory"] = mem

    # 5. watchdog expiries inside the history window (arms/refreshes
    # the sliding-window ring — the /health poll IS the cadence)
    view = timeseries.window_view()
    expired = 0
    for e in view["series"].values():
        if e.get("name") == "watchdog.sections_expired" \
                and e.get("type") == "counter":
            expired += e.get("value", 0)
    components["watchdog"] = {
        "expired_in_window": expired,
        "window_s": round(view["window_s"], 1)}
    if expired:
        score -= 0.2
        reasons.append(
            f"watchdog_expired: {expired} section(s) blew their "
            f"deadline in the last {view['window_s']:.0f}s")

    # 6. scheduler progress — live work + a stale sweep = wedged
    age = engine.last_step_age()
    stall_after = STALL_AGE_S
    components["scheduler"] = {
        "last_step_age_s": (None if age is None else round(age, 3)),
        "stall_after_s": stall_after}
    if live > 0 and age is not None and age > stall_after:
        score -= 0.6
        reasons.append(
            f"scheduler_stalled: {live} live request(s) but no "
            f"scheduler step for {age:.1f}s")

    if getattr(engine, "_closed", False):
        score = 0.0
        reasons.append("engine_closed")

    score = max(round(score, 3), 0.0)
    status = ("ok" if score >= _OK_SCORE else
              "degraded" if score >= _DEGRADED_SCORE else "unhealthy")
    return {"status": status, "score": score, "reasons": reasons,
            "components": components, "live": live,
            "uptime_s": engine.uptime_s}


def maybe_start(engine) -> "IntrospectServer | None":
    """Start the introspection server for ``engine`` IFF
    ``CYLON_TPU_SERVE_HTTP_PORT`` is set — otherwise one env read,
    None returned, no socket/thread exists.

    Startup failures (malformed port value, address already in use)
    are logged LOUDLY and degrade to None instead of raising: the
    endpoint is a diagnostic, and a stale listener on the configured
    port must never take down engine construction — least of all
    ``ServeEngine.recover()``, where failing here would abandon a
    durable engine's journaled requests."""
    port = os.environ.get("CYLON_TPU_SERVE_HTTP_PORT")
    if not port:
        return None
    from cylon_tpu_torch.utils.logging import get_logger

    try:
        return IntrospectServer(engine, int(port))
    except (ValueError, OSError) as e:
        get_logger().warning(
            "introspection endpoint NOT started "
            "(CYLON_TPU_SERVE_HTTP_PORT=%r): %s: %s — the engine "
            "runs without its ops plane", port, type(e).__name__, e)
        return None


class IntrospectServer:
    """One daemon HTTP thread serving an engine's live state (port of
    ``cylon_tpu/serve/introspect.py`` ``IntrospectServer``)."""

    def __init__(self, engine, port: int):
        import http.server

        self._engine = engine
        self._started = time.monotonic()
        outer = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            server_version = "cylon-tpu-torch-introspect"
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):  # quiet by default
                from cylon_tpu_torch.utils.logging import get_logger

                get_logger().debug("introspect: " + fmt, *args)

            def do_GET(self):  # noqa: N802 - stdlib handler name
                try:
                    outer._route(self)
                except BrokenPipeError:  # client went away mid-write
                    pass
                except Exception as e:  # never kill the server thread
                    try:
                        outer._send(self, 500, {
                            "error": f"{type(e).__name__}: {e}"})
                    except Exception:
                        pass

        self._httpd = http.server.ThreadingHTTPServer(
            ("127.0.0.1", port), _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="cylon-serve-introspect", daemon=True)
        self._thread.start()

    @property
    def address(self) -> "tuple[str, int]":
        """(host, port) actually bound (port 0 resolves here)."""
        return self._httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    # ---------------------------------------------------------- routes
    def _send(self, h, code: int, payload, content_type=None) -> None:
        from cylon_tpu_torch import telemetry

        if isinstance(payload, (dict, list)):
            body = json.dumps(telemetry.json_safe(payload),
                              allow_nan=False).encode()
            content_type = content_type or "application/json"
        else:
            body = str(payload).encode()
            content_type = content_type or "text/plain; charset=utf-8"
        h.send_response(code)
        h.send_header("Content-Type", content_type)
        h.send_header("Content-Length", str(len(body)))
        h.end_headers()
        h.wfile.write(body)

    def _route(self, h) -> None:
        from cylon_tpu_torch import telemetry, watchdog
        from cylon_tpu_torch.telemetry import events as _events
        from cylon_tpu_torch.telemetry import timeseries as _ts
        from cylon_tpu_torch.telemetry import trace as _trace

        path, _, query = h.path.partition("?")
        path = path.rstrip("/") or "/"
        qs = urllib.parse.parse_qs(query)
        eng = self._engine
        if path in ("/healthz", "/health") and eng.closing:
            # a drain in progress: close() is joining the scheduler /
            # flushing the journal, and the engine's internals are
            # mid-teardown. Answer the probe CLEANLY (503 = stop
            # routing here) instead of racing the teardown into a 500
            # — the router treats "closing" like "unhealthy", which is
            # the correct drain signal.
            self._send(h, 503, {"status": "closing",
                                "live": eng.live,
                                "uptime_s": eng.uptime_s})
            return
        if path == "/healthz":
            # the cheap liveness probe carries the breaker's
            # observable state + shed counts, so it can never
            # silently disagree with the /health verdict: a prober
            # seeing "ok" while every submit sheds is the bug class
            # this closes
            self._send(h, 200, {
                "status": "closed" if eng._closed else "ok",
                "live": eng.live,
                "uptime_s": time.monotonic() - self._started,
                "breaker": eng._admission.breaker.snapshot(),
                "shed": telemetry.total("serve.shed"),
                "rejected": telemetry.total("serve.rejected"),
            })
        elif path == "/health":
            self._send(h, 200, health_verdict(eng))
        elif path == "/metrics/window":
            window = None
            if qs.get("window"):
                try:
                    window = float(qs["window"][0])
                except ValueError:
                    self._send(h, 400, {
                        "error": f"malformed window "
                                 f"{qs['window'][0]!r}"})
                    return
            self._send(h, 200, _ts.window_view(window))
        elif path == "/events":
            try:
                cursor = int(qs.get("since", ["0"])[0])
            except ValueError:
                self._send(h, 400, {
                    "error": f"malformed since cursor "
                             f"{qs['since'][0]!r}"})
                return
            self._send(h, 200, _events.since(cursor))
        elif path == "/trace":
            try:
                cursor = int(qs.get("since", ["0"])[0])
            except ValueError:
                self._send(h, 400, {
                    "error": f"malformed since cursor "
                             f"{qs['since'][0]!r}"})
                return
            self._send(h, 200, _trace.since(cursor))
        elif path == "/metrics":
            self._send(h, 200, telemetry.to_prometheus(),
                       content_type="text/plain; version=0.0.4; "
                                    "charset=utf-8")
        elif path == "/queries":
            self._send(h, 200, {
                "queries": eng.queries(),
                "active_sections": [
                    {"section": s, "detail": d, "elapsed_s": e}
                    for s, d, e in watchdog.active_sections()],
            })
        elif path == "/tenants":
            self._send(h, 200, eng.tenant_stats())
        elif path == "/tables":
            self._send(h, 200, eng.table_stats())
        elif path == "/views":
            self._send(h, 200, eng.view_stats())
        elif path.startswith("/profiles/"):
            rid = path.rsplit("/", 1)[1]
            ticket = eng.ticket(int(rid)) if rid.isdigit() else None
            if ticket is None:
                self._send(h, 404, {"error": f"unknown rid {rid!r}"})
                return
            prof = ticket.profile()
            if prof is None:
                self._send(h, 404, {
                    "error": f"request {rid} has no profile "
                             "(profiling off?)"})
                return
            self._send(h, 200, prof)
        elif path == "/":
            self._send(h, 200, {"endpoints": list(ENDPOINTS)})
        else:
            self._send(h, 404, {"error": f"unknown path {path!r}",
                                "endpoints": list(ENDPOINTS)})
