"""Replicated serve fleet: N engine processes, one router, zero lost acks
(port of ``cylon_tpu/serve/fleet.py``).

One :class:`~cylon_tpu_torch.serve.ServeEngine` is crash-safe (fsynced
write-ahead journal, snapshot tables, exactly-once replay with
idempotency keys) and answers the router contract (``/health``,
``/metrics/window``, the cursored ``/events?since=`` journal). This
module assembles the fleet — and its chaos proof: kill one engine
mid-run, lose nothing::

                         FleetRouter (this module)
                  poll: /health + /events?since=<cursor>
                  submit: POST /submit → GET /result/<rid>
                 ┌────────────┴────────────┐
           engine process e0         engine process e1
           ServeEngine + gateway     ServeEngine + gateway
                 │                          │
            <root>/engines/e0/        <root>/engines/e1/
              journal.jsonl             journal.jsonl
              journal.lock              journal.lock
                 └────────── <root>/catalog-store ───────┘
                          (shared snapshot store)

* **One durable dir tree** (:class:`FleetLayout`): per-engine journal
  subdirs (each fenced by its own
  :class:`~cylon_tpu_torch.serve.durability.JournalLock`) over ONE
  shared snapshot store (every engine registers the same resident
  tables, so the snapshots are content-identical).
* **An engine gateway** (:class:`EngineGateway`): ``POST /submit``
  admits a registered named query, ``GET /result/<rid>`` long-polls its
  outcome, ``GET /ping`` stamps the engine's clock — on a port of its
  own, so the read-only ops endpoint never grows a control surface.
* **The router** (:class:`FleetRouter`): fleet-scoped idempotency keys,
  routing by verdict tier then tenant affinity, one poll thread per
  engine (``/health`` + ``/events?since=`` + ``/metrics/window``) under
  the ``router_poll`` watchdog section with
  :func:`~cylon_tpu_torch.resilience.retrying` backoff — transport
  failures are ``Code.Unavailable`` (:class:`EngineUnavailable`).
* **Failover**: an engine that fails ``fail_threshold`` consecutive
  polls (or answers unhealthy/closing past ``unhealthy_dwell`` seconds)
  is declared dead. The router (1) **fences** its journal
  (:func:`~cylon_tpu_torch.serve.durability.fence_journal`), (2)
  **replays** its admitted-but-unresolved entries on a surviving peer
  under their ORIGINAL idempotency keys, and (3) re-points every
  affected :class:`RouterTicket`, so a client blocked in ``result()``
  gets its answer. ``fleet.lost_acks`` stays 0; a retried request never
  double-executes.

Telemetry: ``fleet.routed{engine,tenant}``, ``fleet.failovers``,
``fleet.replayed``, ``fleet.lost_acks``, ``fleet.deduped``,
``fleet.events_gap{engine}`` and ``failover`` / ``fence`` /
``events_gap`` entries in the event journal. Armed by
``CYLON_TPU_TRACE``, the router mints a ``trace_id`` a request, carries
it over the HTTP hop as ``X-Cylon-Trace-Id`` / ``X-Cylon-Parent-Span``,
keeps it across a failover replay (a ``fleet.replay_hop`` marker), pulls
every engine's ``/trace?since=`` segments and estimates each engine's
clock offset from ``/ping`` (:meth:`FleetRouter.fleet_trace_buffers`).

Run one engine process (the fleet bench spawns these; CUDA unless
asked, and a child asked for CUDA that finds no device dies before
READY, with the reason in ``<root>/<name>.log``)::

    python -m cylon_tpu_torch.serve.fleet --root /tmp/fleet --name e0 \\
        --sf 0.002 --mix q1,q3,q5,q6 --device cuda

The measured acceptance is ``python -m cylon_tpu_torch.serve.bench
--fleet --clients 16``: two engine processes, one SIGKILLed mid-run.

Differences from the JAX package: the knobs it reads from the
environment are arguments with module-constant defaults —
``FleetRouter(poll_interval=POLL_INTERVAL_S,
fail_threshold=FAIL_THRESHOLD, unhealthy_dwell=UNHEALTHY_DWELL_S)``
(``CYLON_TPU_FLEET_POLL`` / ``_FAIL_THRESHOLD`` / ``_DWELL`` there),
``HttpEngineClient(probe_timeout=PROBE_TIMEOUT_S)``
(``_PROBE_TIMEOUT``), ``FleetRouter(cache_bytes=ROUTER_CACHE_BYTES)``
(``CYLON_TPU_FLEET_RESULT_CACHE_BYTES``), ``run_fleet_bench(root=)``
(``CYLON_BENCH_FLEET_DIR``), and the chaos hooks ``CHAOS_KILL`` /
``CHAOS_OOM`` and the child's stall age are ``spawn_engine`` arguments
passed to the child as flags. ``CYLON_TPU_TRACE``, ``CYLON_TPU_EVENTS``,
``CYLON_TPU_SERVE_HTTP_PORT`` and ``CYLON_TPU_FLEET_LOCK_TTL`` are read
as there. An engine keeps only its mix's manifest columns, warms its
tables' version digests before READY and reports its set-up by stage in
the READY line; at a clean close it logs its kernel launches.
"""

import argparse
import base64
import hashlib
import http.client
import itertools
import json
import os
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

from cylon_tpu_torch import plan, resilience, telemetry, watchdog
from cylon_tpu_torch.errors import (Code, CylonError, DataLossError,
                                    DeadlineExceeded, InvalidArgument,
                                    ResourceExhausted)
from cylon_tpu_torch.serve.bench import (DEFAULT_MIX,
                                         REQUIRED_FLEET_TRACE_FIELDS,
                                         _materialize, _mix_keep,
                                         _mk_resident, _results_match)
from cylon_tpu_torch.serve.durability import RequestJournal, fence_journal
from cylon_tpu_torch.serve.result_cache import (DEFAULT_CACHE_BYTES,
                                                ResultCache,
                                                hook_on_append)
from cylon_tpu_torch.telemetry import events as _events
from cylon_tpu_torch.telemetry import trace as _trace
from cylon_tpu_torch.utils.logging import get_logger

__all__ = [
    "EngineUnavailable", "RemoteRequestFailed", "FleetLayout",
    "EngineGateway", "HttpEngineClient", "LocalEngineClient",
    "RouterTicket", "FleetRouter", "spawn_engine", "EngineProc",
    "run_fleet_bench", "encode_value", "decode_value",
    "snapshot_generations", "audit_double_executions", "DEFAULT_MIX",
    "QUERY_READ_SETS", "REQUIRED_FLEET_TRACE_FIELDS", "POLL_INTERVAL_S",
    "FAIL_THRESHOLD", "UNHEALTHY_DWELL_S", "PROBE_TIMEOUT_S",
    "ROUTER_CACHE_BYTES", "ENGINE_STALL_AGE_S", "value_digest",
]

#: per-query TPC-H read sets — the version-vector half of the result-
#: cache key each fleet engine declares at register_query time. A query
#: not listed falls back to the FULL resident set (over-invalidation is
#: merely slower; under-invalidation would serve stale bytes).
QUERY_READ_SETS = {
    "q1": ("lineitem",),
    "q3": ("customer", "orders", "lineitem"),
    "q4": ("orders", "lineitem"),
    "q5": ("customer", "orders", "lineitem", "supplier", "nation",
           "region"),
    "q6": ("lineitem",),
    "q7": ("supplier", "lineitem", "orders", "customer", "nation"),
    "q10": ("customer", "orders", "lineitem", "nation"),
    "q12": ("orders", "lineitem"),
    "q14": ("lineitem", "part"),
    "q18": ("customer", "orders", "lineitem"),
    "q19": ("lineitem", "part"),
}

#: router poll interval in seconds (``CYLON_TPU_FLEET_POLL`` there)
POLL_INTERVAL_S = 0.5
#: consecutive failed polls that declare an engine dead
#: (``CYLON_TPU_FLEET_FAIL_THRESHOLD`` there)
FAIL_THRESHOLD = 3
#: seconds an engine may answer unhealthy/closing before it is declared
#: dead (``CYLON_TPU_FLEET_DWELL`` there)
UNHEALTHY_DWELL_S = 5.0
#: per-probe HTTP timeout in seconds: a busy engine is not a dead one
#: (``CYLON_TPU_FLEET_PROBE_TIMEOUT`` there)
PROBE_TIMEOUT_S = 30.0
#: the router's fleet-scoped result-cache budget in bytes, the default
#: of ``FleetRouter(cache_bytes=)``; 0 switches the cache off
#: (``CYLON_TPU_FLEET_RESULT_CACHE_BYTES`` there)
ROUTER_CACHE_BYTES = DEFAULT_CACHE_BYTES
#: the stall age :func:`spawn_engine` gives a child's ``/health`` probe
#: (``serve.introspect.STALL_AGE_S``, 10 s in one process): one degraded
#: request can hold the scheduler longer than 10 s, and a stall read as
#: unhealthy would dwell a live engine to death
ENGINE_STALL_AGE_S = 120.0
#: how long a submit whose connection broke mid-request waits for its
#: engine's failover before it raises (the engine may have admitted it)
AMBIGUOUS_SUBMIT_WAIT_S = 30.0
#: how long the fleet bench waits after its clients for the router to
#: declare the killed engine dead before it reads the report
FAILOVER_WAIT_S = 60.0


class EngineUnavailable(CylonError):
    """An engine's HTTP surface could not be reached (connection
    refused, reset, timeout, or a 5xx from a dying process). Carries
    ``Code.Unavailable`` so :func:`cylon_tpu_torch.resilience.is_retryable`
    classifies it retryable — only a run of consecutive exhausted
    retries declares the engine dead.

    ``refused`` is True when the failure was a connection REFUSAL — no
    listener, so the request provably never reached admission: the one
    transport failure a submit may re-route on unconditionally.

    (port of ``cylon_tpu/serve/fleet.py`` ``EngineUnavailable``)"""

    code = Code.Unavailable
    refused = False


class RemoteRequestFailed(CylonError):
    """A fleet-routed request FAILED on its engine (the error is the
    request's outcome). ``kind`` keeps the engine-side error class
    name. (port of ``cylon_tpu/serve/fleet.py`` ``RemoteRequestFailed``)"""

    def __init__(self, msg: str = "", kind: "str | None" = None):
        super().__init__(msg)
        self.kind = kind


# --------------------------------------------------------- value codec
def _missing(x) -> bool:
    """A missing value of a string or object column: None, ``pd.NA``,
    ``pd.NaT`` or a float NaN (pandas' string dtype reads a missing
    value as NaN)."""
    if x is None:
        return True
    if isinstance(x, float):
        return x != x
    try:
        import pandas as pd
    except ImportError:  # pragma: no cover - pandas is a hard dep here
        return False
    return x is pd.NA or x is pd.NaT


def encode_value(v) -> dict:
    """JSON-able envelope for a query result crossing the gateway:
    pandas DataFrames (column-wise, dtype-tagged, datetimes as int64 ns,
    bytes base64), numpy arrays, numpy/python scalars. Floats ride
    native JSON; non-finite floats keep tags so they decode exactly. A
    missing value in a string or object column (None, ``pd.NA``, NaN)
    encodes as None; a nullable number or boolean column keeps its
    pandas dtype and its missing values as None.

    (port of ``cylon_tpu/serve/fleet.py`` ``encode_value``)"""
    import numpy as np

    import pandas as pd

    def _enc_float(x):
        # strict JSON has no Infinity/NaN tokens
        if x != x:
            return {"__f__": "nan"}
        if x == float("inf"):
            return {"__f__": "inf"}
        if x == float("-inf"):
            return {"__f__": "-inf"}
        return x

    def _enc_item(x):
        if x is None or x is pd.NA or x is pd.NaT:
            return None
        if isinstance(x, bytes):
            return {"__b64__": base64.b64encode(x).decode("ascii")}
        if isinstance(x, (str, bool, int)):
            return x
        if isinstance(x, float):
            return _enc_float(x)
        if isinstance(x, np.generic):
            return _enc_item(x.item())
        raise InvalidArgument(
            f"fleet result codec cannot encode {type(x).__name__}")

    def _enc_cell(x):
        # a string, object or nullable column's cell: NaN there is a
        # missing value, while a float scalar or float column keeps it
        return None if _missing(x) else _enc_item(x)

    def _obj(items) -> dict:
        return {"dtype": "object", "kind": "obj",
                "data": [_enc_cell(x) for x in items]}

    def _enc_col(col):
        if isinstance(col, pd.Series):
            dt = col.dtype
            if isinstance(dt, pd.api.extensions.ExtensionDtype) and \
                    not pd.api.types.is_string_dtype(dt) and \
                    (pd.api.types.is_numeric_dtype(dt)
                     or pd.api.types.is_bool_dtype(dt)):
                # nullable Int64 / Float64 / boolean: dtype kept
                return {"dtype": str(dt), "kind": "ext",
                        "data": [_enc_cell(x) for x in
                                 col.astype(object).tolist()]}
            if pd.api.types.is_string_dtype(dt):
                return _obj(col.astype(object).tolist())
            col = col.to_numpy()
        arr = np.asarray(col)
        if np.issubdtype(arr.dtype, np.datetime64):
            return {"dtype": str(arr.dtype), "kind": "datetime",
                    "data": arr.astype("int64").tolist()}
        if arr.dtype != object and (
                np.issubdtype(arr.dtype, np.number)
                or arr.dtype == bool):
            data = arr.tolist()
            if np.issubdtype(arr.dtype, np.floating):
                data = [_enc_float(x) for x in data]
            return {"dtype": str(arr.dtype), "kind": "num",
                    "data": data}
        return _obj(arr.tolist())

    if isinstance(v, pd.DataFrame):
        return {"__fleet__": "frame", "columns": list(map(str, v.columns)),
                "cols": {str(c): _enc_col(v[c]) for c in v.columns}}
    if isinstance(v, np.ndarray):
        return {"__fleet__": "ndarray", "col": _enc_col(v)}
    return {"__fleet__": "scalar", "data": _enc_item(v)}


def decode_value(env: "dict | None"):
    """Inverse of :func:`encode_value`.

    (port of ``cylon_tpu/serve/fleet.py`` ``decode_value``)"""
    import numpy as np
    import pandas as pd

    if env is None:
        return None

    specials = {"nan": float("nan"), "inf": float("inf"),
                "-inf": float("-inf")}

    def _dec_item(x):
        if isinstance(x, dict):
            if "__b64__" in x:
                return base64.b64decode(x["__b64__"])
            if "__f__" in x:
                return specials[x["__f__"]]
        return x

    def _dec_col(c):
        if c["kind"] == "datetime":
            return np.asarray(c["data"],
                              dtype="int64").astype(c["dtype"])
        if c["kind"] == "num":
            data = [_dec_item(x) for x in c["data"]]
            return np.asarray(data, dtype=np.dtype(c["dtype"]))
        if c["kind"] == "ext":
            return pd.array([_dec_item(x) for x in c["data"]],
                            dtype=c["dtype"])
        out = np.empty(len(c["data"]), dtype=object)
        out[:] = [_dec_item(x) for x in c["data"]]
        return out

    def _series(c):
        col = _dec_col(c)
        # object stays object: pandas would infer its string dtype and
        # read None back as NaN
        return pd.Series(col, dtype=object) if c["kind"] == "obj" else col

    kind = env.get("__fleet__")
    if kind == "frame":
        return pd.DataFrame({c: _series(env["cols"][c])
                             for c in env["columns"]},
                            columns=env["columns"])
    if kind == "ndarray":
        return _dec_col(env["col"])
    if kind == "scalar":
        return _dec_item(env.get("data"))
    raise InvalidArgument(f"unknown fleet value envelope {kind!r}")


# --------------------------------------------------------- layout
class FleetLayout:
    """The shared durable dir tree: per-engine journal subdirs under
    ``<root>/engines/<name>/`` (each with its own lockfile fence) plus
    ONE shared snapshot store at ``<root>/catalog-store``.

    (port of ``cylon_tpu/serve/fleet.py`` ``FleetLayout``)"""

    def __init__(self, root: str):
        self.root = str(root)

    @property
    def engines_root(self) -> str:
        return os.path.join(self.root, "engines")

    def engine_dir(self, name: str) -> str:
        return os.path.join(self.engines_root, str(name))

    @property
    def snapshot_dir(self) -> str:
        return os.path.join(self.root, "catalog-store")

    def engine_names(self) -> "list[str]":
        try:
            return sorted(os.listdir(self.engines_root))
        except OSError:
            return []


def snapshot_generations(root: str) -> "dict[str, int]":
    """Per-table generation stamps in the fleet's SHARED snapshot store
    at ``<root>/catalog-store``: what a failover target's
    :meth:`ServeEngine.recover` would restore.

    (port of ``cylon_tpu/serve/fleet.py`` ``snapshot_generations``)"""
    from cylon_tpu_torch.serve.durability import CatalogSnapshot

    return CatalogSnapshot(FleetLayout(root).snapshot_dir).generations()


# --------------------------------------------------------- gateway
class EngineGateway:
    """The per-engine-process submission surface the router talks to.

    Separate from the read-only ops endpoint (``serve/introspect.py``):
    ``POST /submit`` admits one REGISTERED named query through the
    engine's public :meth:`~ServeEngine.submit_named` — journaled
    write-ahead, idempotency-key deduped and SLO-stamped exactly like a
    local one — ``GET /result/<rid>`` long-polls the ticket's outcome
    and ``GET /ping`` answers liveness with the engine's wall clock.
    Loopback only.

    (port of ``cylon_tpu/serve/fleet.py`` ``EngineGateway``)"""

    def __init__(self, engine, port: int = 0):
        import http.server

        self._engine = engine
        outer = self

        class _Handler(http.server.BaseHTTPRequestHandler):
            server_version = "cylon-tpu-torch-fleet-gateway"
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                get_logger().debug("gateway: " + fmt, *args)

            def _reply(self, code: int, payload: dict) -> None:
                body = json.dumps(telemetry.json_safe(payload),
                                  allow_nan=False).encode()
                self.send_response(code)
                self.send_header("Content-Type", "application/json")
                self.send_header("Content-Length", str(len(body)))
                self.end_headers()
                self.wfile.write(body)

            def _serve(self, handler) -> None:
                try:
                    handler(self)
                except BrokenPipeError:
                    pass
                except Exception as e:  # never kill the server thread
                    try:
                        self._reply(500, {
                            "error": f"{type(e).__name__}: {e}",
                            "kind": type(e).__name__})
                    except Exception:
                        pass

            def do_GET(self):  # noqa: N802 - stdlib handler name
                self._serve(outer._get)

            def do_POST(self):  # noqa: N802 - stdlib handler name
                self._serve(outer._post)

        self._httpd = http.server.ThreadingHTTPServer(
            ("127.0.0.1", int(port)), _Handler)
        self._httpd.daemon_threads = True
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            name="cylon-fleet-gateway", daemon=True)
        self._thread.start()

    @property
    def address(self) -> "tuple[str, int]":
        return self._httpd.server_address[:2]

    @property
    def url(self) -> str:
        host, port = self.address
        return f"http://{host}:{port}"

    def close(self) -> None:
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5)

    # ------------------------------------------------------- handlers
    def _get(self, h) -> None:
        import urllib.parse

        path, _, query = h.path.partition("?")
        qs = urllib.parse.parse_qs(query)
        eng = self._engine
        if path == "/ping":
            h._reply(503 if eng.closing else 200,
                     {"ok": not eng.closing, "closing": eng.closing,
                      "live": eng.live,
                      # wall-clock stamp for the router's clock-offset
                      # handshake: offset = ts - (t0 + t1)/2
                      "ts": time.time()})
            return
        if path.startswith("/result/"):
            rid = path.rsplit("/", 1)[1]
            ticket = eng.ticket(int(rid)) if rid.isdigit() else None
            if ticket is None:
                h._reply(404, {"error": f"unknown rid {rid!r}",
                               "kind": "NotFound"})
                return
            try:
                wait_s = min(float(qs.get("timeout", ["0"])[0]), 60.0)
            except ValueError:
                wait_s = 0.0
            if wait_s > 0:
                ticket.wait(wait_s)
            if not ticket.done:
                h._reply(200, {"state": "running", "rid": ticket.rid})
                return
            if ticket.error is not None:
                h._reply(200, {
                    "state": "failed", "rid": ticket.rid,
                    "error": str(ticket.error),
                    "kind": type(ticket.error).__name__})
                return
            h._reply(200, {"state": "done", "rid": ticket.rid,
                           "value": encode_value(ticket.value),
                           # the (fingerprint, version vector) the engine
                           # published this result under (None when
                           # uncacheable): the router's cache key
                           "cache_key": ticket.cache_key})
            return
        h._reply(404, {"error": f"unknown path {path!r}",
                       "kind": "NotFound"})

    def _post(self, h) -> None:
        eng = self._engine
        if h.path.partition("?")[0] != "/submit":
            h._reply(404, {"error": f"unknown path {h.path!r}",
                           "kind": "NotFound"})
            return
        if eng.closing:
            h._reply(503, {"error": "engine closing",
                           "kind": "Unavailable"})
            return
        try:
            n = int(h.headers.get("Content-Length", "0"))
            body = json.loads(h.rfile.read(n) or b"{}")
        except ValueError as e:
            h._reply(400, {"error": f"malformed submit body: {e}",
                           "kind": "InvalidArgument"})
            return
        # the fleet trace context crosses the process hop as headers,
        # never as body kwargs: the journal records the query's OWN
        # kwargs, so a replay's fingerprint still matches
        tid = h.headers.get("X-Cylon-Trace-Id")
        parent = h.headers.get("X-Cylon-Parent-Span")
        if parent is not None and parent.isdigit():
            parent = int(parent)
        try:
            ticket = eng.submit_named(
                str(body["name"]), *body.get("args", ()),
                idempotency_key=body.get("key"),
                tenant=body.get("tenant", "default"),
                priority=int(body.get("priority", 1)),
                slo=body.get("slo"),
                tables=body.get("tables", ()),
                _trace_id=tid, _parent_span=parent,
                **body.get("kwargs", {}))
        except ResourceExhausted as e:
            h._reply(429, {"error": str(e), "kind": "ResourceExhausted"})
            return
        except (InvalidArgument, KeyError) as e:
            h._reply(400, {"error": str(e), "kind": type(e).__name__})
            return
        h._reply(200, {"rid": ticket.rid, "state": ticket.state,
                       "tenant": ticket.tenant})


# --------------------------------------------------------- clients
class HttpEngineClient:
    """The router's handle on one engine PROCESS: the gateway port for
    submit/result/ping, the ops port for /health, /events, /trace and
    /metrics/window. Every transport failure maps to
    :class:`EngineUnavailable` (``Code.Unavailable`` — retryable).
    ``probe_timeout``: seconds a probe waits — generous, because a busy
    engine is not a dead one (a SIGKILLed one refuses at once).

    (port of ``cylon_tpu/serve/fleet.py`` ``HttpEngineClient``)"""

    def __init__(self, name: str, gateway_url: str,
                 introspect_url: "str | None" = None,
                 durable_dir: "str | None" = None,
                 pid: "int | None" = None,
                 probe_timeout: float = PROBE_TIMEOUT_S):
        self.name = str(name)
        self.gateway_url = gateway_url.rstrip("/")
        self.introspect_url = (introspect_url.rstrip("/")
                               if introspect_url else None)
        self.durable_dir = durable_dir
        self.pid = pid
        self.probe_timeout = float(probe_timeout)

    def _request(self, url: str, data: "bytes | None" = None,
                 timeout: float = 10.0,
                 headers: "dict | None" = None) -> dict:
        hdrs = {"Content-Type": "application/json"} if data else {}
        if headers:
            hdrs.update(headers)
        req = urllib.request.Request(url, data=data, headers=hdrs)
        try:
            with urllib.request.urlopen(req, timeout=timeout) as r:
                return json.loads(r.read())
        except urllib.error.HTTPError as e:
            try:
                payload = json.loads(e.read())
            except Exception:
                payload = {"error": str(e), "kind": "HTTPError"}
            if e.code == 503:
                # a clean "closing"/unavailable verdict, not a crash
                payload.setdefault("status", "closing")
                payload["http_status"] = 503
                return payload
            if e.code == 429:
                raise ResourceExhausted(payload.get("error", str(e)))
            if e.code in (400, 404, 409):
                raise InvalidArgument(payload.get("error", str(e)))
            if "kind" in payload:
                # the GATEWAY's error envelope: the engine is alive and
                # answered — an application failure must not read as
                # engine death and trip a failover
                raise RemoteRequestFailed(
                    f"engine {self.name!r} request failed: "
                    f"{payload.get('error', '')}",
                    kind=payload.get("kind"))
            raise EngineUnavailable(
                f"engine {self.name!r} answered HTTP {e.code}: "
                f"{payload.get('error', '')}")
        except (urllib.error.URLError, ConnectionError, OSError,
                TimeoutError, http.client.HTTPException) as e:
            # includes IncompleteRead / RemoteDisconnected: the process
            # died (or was SIGKILLed) mid-response
            reason = getattr(e, "reason", e)
            exc = EngineUnavailable(
                f"engine {self.name!r} unreachable at {url}: "
                f"{type(e).__name__}: {e}")
            exc.refused = isinstance(reason, ConnectionRefusedError)
            raise exc

    # ------------------------------------------------- router surface
    def submit(self, name: str, args=(), kwargs=None,
               tenant: str = "default", priority: int = 1,
               slo=None, key: "str | None" = None,
               tables=(), trace_id: "str | None" = None,
               parent_span=None) -> int:
        body = {"name": name, "args": list(args),
                "kwargs": dict(kwargs or {}), "tenant": tenant,
                "priority": priority, "slo": slo, "key": key,
                "tables": list(tables)}
        headers = {}
        if trace_id is not None:
            headers["X-Cylon-Trace-Id"] = str(trace_id)
            if parent_span is not None:
                headers["X-Cylon-Parent-Span"] = str(parent_span)
        out = self._request(self.gateway_url + "/submit",
                            data=json.dumps(body).encode(),
                            timeout=max(self.probe_timeout, 10.0),
                            headers=headers or None)
        if "rid" not in out:
            raise EngineUnavailable(
                f"engine {self.name!r} refused submit: {out}")
        return int(out["rid"])

    def result(self, rid: int, timeout: float = 5.0) -> dict:
        return self._request(
            f"{self.gateway_url}/result/{int(rid)}?timeout={timeout}",
            timeout=timeout + max(self.probe_timeout, 10.0))

    def health(self) -> dict:
        base = self.introspect_url or self.gateway_url
        path = "/health" if self.introspect_url else "/ping"
        return self._request(base + path, timeout=self.probe_timeout)

    def _cursored(self, path: str, cursor: int) -> dict:
        if self.introspect_url is None:
            return {"events": [], "cursor": int(cursor), "dropped": 0,
                    "armed": False}
        return self._request(
            f"{self.introspect_url}/{path}?since={int(cursor)}",
            timeout=self.probe_timeout)

    def events_since(self, cursor: int = 0) -> dict:
        return self._cursored("events", cursor)

    def trace_since(self, cursor: int = 0) -> dict:
        """The engine's cursored ``/trace?since=`` span segment."""
        return self._cursored("trace", cursor)

    def ping(self) -> dict:
        """Raw gateway liveness reply, with the engine's wall ``ts``."""
        return self._request(self.gateway_url + "/ping",
                             timeout=self.probe_timeout)

    def metrics_window(self, window: "float | None" = None) -> dict:
        if self.introspect_url is None:
            return {}
        q = f"?window={window}" if window else ""
        return self._request(
            self.introspect_url + "/metrics/window" + q,
            timeout=self.probe_timeout)


class LocalEngineClient:
    """The same client interface over an IN-PROCESS engine — the fleet
    logic is identical whether the engine is a process or an object, so
    the router's routing and failover test without spawns. Talks only
    through the engine's public API.

    (port of ``cylon_tpu/serve/fleet.py`` ``LocalEngineClient``)"""

    def __init__(self, engine, name: str,
                 durable_dir: "str | None" = None):
        self.engine = engine
        self.name = str(name)
        self.durable_dir = durable_dir or engine.durable_dir
        self.pid = os.getpid()

    def submit(self, name: str, args=(), kwargs=None,
               tenant: str = "default", priority: int = 1,
               slo=None, key: "str | None" = None,
               tables=(), trace_id: "str | None" = None,
               parent_span=None) -> int:
        if self.engine.closing:
            e = EngineUnavailable(f"engine {self.name!r} is closing")
            e.refused = True  # nothing admitted: safe to re-route
            raise e
        t = self.engine.submit_named(
            name, *args, idempotency_key=key, tenant=tenant,
            priority=priority, slo=slo, tables=tables,
            _trace_id=trace_id, _parent_span=parent_span,
            **(kwargs or {}))
        return t.rid

    def result(self, rid: int, timeout: float = 5.0) -> dict:
        t = self.engine.ticket(rid)
        if t is None:
            raise EngineUnavailable(f"engine {self.name!r} lost rid {rid}")
        t.wait(timeout)
        if not t.done:
            return {"state": "running", "rid": rid}
        if t.error is not None:
            return {"state": "failed", "rid": rid, "error": str(t.error),
                    "kind": type(t.error).__name__}
        return {"state": "done", "rid": rid,
                "value": encode_value(t.value), "cache_key": t.cache_key}

    def health(self) -> dict:
        if self.engine.closing:
            return {"status": "closing"}
        return self.engine.health()

    def events_since(self, cursor: int = 0) -> dict:
        return _events.since(cursor)

    def trace_since(self, cursor: int = 0) -> dict:
        return _trace.since(cursor)

    def ping(self) -> dict:
        # in-process: the router's own clock, so the handshake's
        # midpoint estimate converges on ~0 offset
        return {"ok": not self.engine.closing,
                "closing": self.engine.closing, "ts": time.time()}

    def metrics_window(self, window: "float | None" = None) -> dict:
        from cylon_tpu_torch.telemetry import timeseries

        return timeseries.window_view(window)


# --------------------------------------------------------- router
def _affinity_order(tenant: str, names: "list[str]") -> "list[str]":
    """Deterministic tenant-affinity ring: the tenant's md5 picks a
    starting engine, failures walk the ring. Stable across processes
    (no PYTHONHASHSEED dependence) and equal to the JAX package's.

    (port of ``cylon_tpu/serve/fleet.py`` ``_affinity_order``)"""
    names = sorted(names)
    if not names:
        return []
    h = int.from_bytes(
        hashlib.md5(str(tenant).encode()).digest()[:4], "big")
    k = h % len(names)
    return names[k:] + names[:k]


class _EngineState:
    """Router-side view of one engine."""

    def __init__(self, client):
        self.client = client
        self.name = client.name
        self.verdict: "dict | None" = None
        self.status = "unknown"
        self.failures = 0          # consecutive failed polls
        self.unhealthy_since: "float | None" = None
        self.dead = False
        self.last_window: "dict | None" = None
        self.events_seen = 0
        # fleet tracing: the engine's pulled /trace segment stream and
        # the ping-handshake clock estimate — idle until armed
        self.trace_cursor = 0
        self.trace_events: list = []
        self.trace_dropped = 0
        self.clock_offset: "float | None" = None
        self.offset_jitter: "float | None" = None

    def snapshot(self) -> dict:
        return {"name": self.name, "status": self.status,
                "dead": self.dead, "failures": self.failures,
                "events_seen": self.events_seen}


class RouterTicket:
    """The fleet-level future: survives the engine it was first routed
    to. ``result()`` long-polls the current assignment and, when a
    failover re-points the ticket at a peer, keeps polling there.

    (port of ``cylon_tpu/serve/fleet.py`` ``RouterTicket``)"""

    def __init__(self, router: "FleetRouter", key: str, name: str,
                 tenant: str):
        self._router = router
        self.key = key
        self.name = name
        self.tenant = tenant
        self._cv = threading.Condition()
        self._client = None
        self.rid: "int | None" = None
        self._lost: "str | None" = None
        self.submitted = time.monotonic()
        #: the fleet trace id minted for this request (None unarmed)
        self.trace_id: "str | None" = None

    @property
    def engine(self) -> "str | None":
        with self._cv:
            return None if self._client is None else self._client.name

    def _assign(self, client, rid: int) -> None:
        # dead-ness checked OUTSIDE _cv (router lock order: never
        # _cv → _mu): a failover replay may already have re-pointed this
        # ticket at a live peer — a stale assignment to the dead engine
        # must not overwrite it
        new_dead = self._router._is_dead(getattr(client, "name", None))
        with self._cv:
            if self._client is not None and new_dead:
                return
            self._client, self.rid = client, int(rid)
            self._cv.notify_all()

    def _mark_lost(self, why: str) -> None:
        """Declare this acknowledged request LOST — the one place the
        per-ticket ``fleet.lost_acks`` count happens."""
        with self._cv:
            if self._lost is not None:
                return
            self._lost = why
            self._cv.notify_all()
        telemetry.counter("fleet.lost_acks", tenant=self.tenant).inc()

    def result(self, timeout: "float | None" = None):
        deadline = (None if timeout is None
                    else time.monotonic() + timeout)
        while True:
            done, value = self._router._acked(self.key)
            if done:
                return value
            failed = self._router._failure(self.key)
            if failed is not None:
                raise RemoteRequestFailed(
                    f"request {self.key!r} failed on engine "
                    f"{failed['engine']}: {failed['error']}",
                    kind=failed["kind"])
            with self._cv:
                if self._lost is not None:
                    raise DataLossError(
                        f"acknowledged request {self.key!r} was LOST: "
                        f"{self._lost}")
                client, rid = self._client, self.rid
            remaining = (None if deadline is None
                         else deadline - time.monotonic())
            if remaining is not None and remaining <= 0:
                raise DeadlineExceeded(
                    f"result({timeout=}) timed out waiting on fleet "
                    f"request {self.key!r}", section="router_poll",
                    retryable=True)
            chunk = 5.0 if remaining is None else min(remaining, 5.0)
            if client is None:  # awaiting failover reassignment
                with self._cv:
                    if self._client is None and self._lost is None:
                        self._cv.wait(min(chunk, 0.25))
                continue
            try:
                res = client.result(rid, timeout=chunk)
            except EngineUnavailable:
                # the engine died under us: count toward its failure
                # threshold and wait for a reassignment or a lost verdict
                self._router._note_failure(client.name,
                                           reason="result_poll")
                with self._cv:
                    if self._client is client and self._lost is None:
                        self._cv.wait(0.25)
                continue
            state = res.get("state")
            if state == "done":
                value = decode_value(res.get("value"))
                self._router._store_result(res.get("cache_key"),
                                           res.get("value"))
                self._router._record_ack(self.key, value)
                return value
            if state == "failed":
                self._router._record_failure(
                    self.key, engine=client.name,
                    error=res.get("error", ""),
                    kind=res.get("kind", "Error"))
                raise RemoteRequestFailed(
                    f"request {self.key!r} failed on engine "
                    f"{client.name}: {res.get('error', '')}",
                    kind=res.get("kind"))
            # running (or a 503 "closing" envelope): poll again


class FleetRouter:
    """Tenant-affinity + health-verdict routing over N engines, with
    journal-replay failover (module docstring). ``clients`` is any mix
    of :class:`HttpEngineClient` (engine processes) and
    :class:`LocalEngineClient` (in-process engines).

    (port of ``cylon_tpu/serve/fleet.py`` ``FleetRouter``)"""

    def __init__(self, clients, poll_interval: float = POLL_INTERVAL_S,
                 fail_threshold: int = FAIL_THRESHOLD,
                 unhealthy_dwell: float = UNHEALTHY_DWELL_S,
                 cache_bytes: int = ROUTER_CACHE_BYTES,
                 retry_policy=None, start: bool = True):
        clients = list(clients)
        if len({c.name for c in clients}) != len(clients):
            raise InvalidArgument("engine names must be unique")
        self._mu = threading.RLock()
        self._states = {c.name: _EngineState(c) for c in clients}
        self._cursors = {c.name: 0 for c in clients}
        # fleet tracing arms off the SAME switch as the local recorder,
        # read once: an unarmed router never mints ids, opens spans,
        # handshakes clocks or pulls /trace
        self._trace_armed = _trace.enabled()
        self.poll_interval = float(poll_interval)
        self.fail_threshold = max(int(fail_threshold), 1)
        self.unhealthy_dwell = float(unhealthy_dwell)
        self._retry_policy = retry_policy
        # the FLEET-scoped versioned result cache: keyed like the
        # engine-side cache — (query fingerprint, table-version vector)
        # — but holding the ENCODED envelopes the gateways reply with,
        # so a hit serves every engine and survives the engine the
        # result first ran on. The router learns a key only from a done
        # reply's ``cache_key``; ``_vv_by_fp`` maps fingerprint -> the
        # last vector an engine answered with (a stale mapping can only
        # MISS, never hit stale)
        self._result_cache = hook_on_append(ResultCache(
            cache_bytes, metric_prefix="fleet"))
        self._vv_by_fp: "dict[str, tuple]" = {}
        self._tickets: "dict[str, RouterTicket]" = {}
        self._acks: "dict[str, object]" = {}
        self._failures: "dict[str, dict]" = {}
        self._replayed_keys: "list[str]" = []
        self._failovers: "list[dict]" = []
        self._kseq = itertools.count(1)
        self._stop = threading.Event()
        #: ONE poll thread per engine: a hung-but-listening engine must
        #: not head-of-line-block the detection of another's death
        self._pollers: "dict[str, threading.Thread]" = {}
        if start:
            self.start()

    # ------------------------------------------------------- lifecycle
    def start(self) -> None:
        with self._mu:
            for name in self._states:
                th = self._pollers.get(name)
                if th is not None and th.is_alive():
                    continue
                th = threading.Thread(
                    target=self._poll_loop, args=(name,),
                    name=f"cylon-fleet-poll-{name}", daemon=True)
                self._pollers[name] = th
                th.start()

    def close(self) -> None:
        """Stop the poll loops (the engines belong to their owner)."""
        self._stop.set()
        for th in list(self._pollers.values()):
            th.join(timeout=5)

    def __enter__(self) -> "FleetRouter":
        return self

    def __exit__(self, *exc) -> None:
        self.close()

    def wait_for_verdicts(self, timeout: float = 60.0) -> bool:
        """Wait until every engine has been polled once (an unpolled
        engine ranks below a polled one, so a tenant's affinity engine
        could lose its first requests to a peer); False on timeout."""
        give_up = time.monotonic() + timeout
        while True:
            with self._mu:
                if all(s.status != "unknown" for s in self._states.values()):
                    return True
            if time.monotonic() > give_up:
                return False
            time.sleep(0.02)

    # ------------------------------------------------------- routing
    def engines(self) -> "list[dict]":
        with self._mu:
            return [s.snapshot() for s in self._states.values()]

    def _eligible_locked(self) -> "list[_EngineState]":
        """Routable engines, best verdict first: ``ok``, then
        ``degraded``, then never-polled ``unknown`` (a just-started
        fleet must route before the first poll lands).
        ``unhealthy``/``closing``/dead engines never route."""
        rank = {"ok": 0, "degraded": 1, "unknown": 2}
        out = [s for s in self._states.values()
               if not s.dead and s.status in rank]
        out.sort(key=lambda s: (rank[s.status], s.name))
        return out

    def _pick_locked(self, tenant: str,
                     exclude=frozenset()) -> "_EngineState":
        eligible = [s for s in self._eligible_locked()
                    if s.name not in exclude]
        if not eligible:
            raise EngineUnavailable(
                f"no routable engine in the fleet (states: "
                f"{[s.snapshot() for s in self._states.values()]})")
        # route within the best-status tier only; the tenant's affinity
        # ring breaks ties
        order = ("ok", "degraded", "unknown")
        best_rank = min(order.index(s.status) for s in eligible)
        tier = {s.name: s for s in eligible
                if order.index(s.status) == best_rank}
        name = _affinity_order(tenant, list(tier))[0]
        return tier[name]

    def submit(self, name: str, *args, tenant: str = "default",
               idempotency_key: "str | None" = None,
               priority: int = 1, slo=None, tables=(),
               **kwargs) -> RouterTicket:
        """Admit one named query into the fleet. ``idempotency_key`` is
        FLEET-scoped: a key the router already holds returns its ticket
        (no engine is touched); an unknown key is stamped on the
        engine-side journal, so a failover replay and a client retry can
        never both execute. Keys are generated when the client brings
        none (the replay path needs one).

        When tracing is armed this is the request's OUTERMOST entry: it
        mints the ``trace_id``, opens the router-side ``fleet.submit``
        span, and hands both across the HTTP hop."""
        if not self._trace_armed:
            return self._submit_routed(
                name, args, kwargs, tenant=tenant,
                idempotency_key=idempotency_key, priority=priority,
                slo=slo, tables=tables, trace_id=None, parent_span=None)
        trace_id = _trace.new_trace_id()
        with _trace.trace_context(trace_id):
            tok = _trace.begin("fleet.submit", cat="fleet",
                               query=str(name), tenant=str(tenant))
            try:
                return self._submit_routed(
                    name, args, kwargs, tenant=tenant,
                    idempotency_key=idempotency_key,
                    priority=priority, slo=slo, tables=tables,
                    trace_id=trace_id,
                    parent_span=tok[0] if tok else None)
            finally:
                _trace.end(tok)

    def _submit_routed(self, name, args, kwargs, *, tenant,
                       idempotency_key, priority, slo, tables,
                       trace_id, parent_span) -> RouterTicket:
        key = idempotency_key or f"fleet-{os.getpid()}-{next(self._kseq)}"
        with self._mu:
            existing = self._tickets.get(key)
            if existing is not None:
                telemetry.counter("fleet.deduped", tenant=tenant).inc()
                return existing
            ticket = RouterTicket(self, key, name, tenant)
            ticket.trace_id = trace_id
            self._tickets[key] = ticket
        # the fleet-scoped cache BEFORE any engine is touched: the
        # fingerprint is computed here (the engines' canonical JSON),
        # the version vector is the one an engine last answered it with
        # — an append anywhere invalidated the entry under it, so a hit
        # is current. It resolves through the ack ledger (0 round trips)
        if self._result_cache.enabled:
            fp = plan.query_fingerprint(name, args, kwargs)
            if fp is not None:
                with self._mu:
                    vv = self._vv_by_fp.get(fp)
                hit, env = self._result_cache.lookup(fp, vv)
                if hit:
                    self._record_ack(key, decode_value(env))
                    return ticket
        # a submit that lands in an engine's death window walks the
        # affinity ring to the next peer. Re-routing with the SAME key is
        # safe ONLY when the first attempt provably did not execute: a
        # connection REFUSAL, or an engine whose failover has completed
        # (fenced, so an admit it journaled was replayed and re-pointed
        # this ticket; else it never admitted the key). An ambiguous
        # failure (a reset mid-submit) waits for the engine's fate, and
        # raises when the engine lives on
        tried: set = set()
        while True:
            try:
                with self._mu:
                    st = self._pick_locked(tenant, exclude=tried)
            except EngineUnavailable:
                with self._mu:
                    self._tickets.pop(key, None)
                raise
            try:
                rid = st.client.submit(
                    name, args=args, kwargs=kwargs, tenant=tenant,
                    priority=priority, slo=slo, key=key,
                    tables=tables, trace_id=trace_id,
                    parent_span=parent_span)
            except EngineUnavailable as e:
                self._note_failure(st.name, reason="submit")
                if not (getattr(e, "refused", False)
                        or self._failed_over(st.name,
                                             AMBIGUOUS_SUBMIT_WAIT_S)):
                    with self._mu:
                        self._tickets.pop(key, None)
                    raise
                if ticket.engine is not None:
                    # the failover replayed this admitted request
                    return ticket
                tried.add(st.name)
                get_logger().warning(
                    "fleet: submit of %r to %r failed (%s); re-routing",
                    key, st.name, e)
                continue
            except BaseException:
                with self._mu:
                    self._tickets.pop(key, None)
                raise
            break
        ticket._assign(st.client, rid)
        telemetry.counter("fleet.routed", engine=st.name,
                          tenant=tenant).inc()
        return ticket

    # ------------------------------------------------------- acks
    def _record_ack(self, key: str, value) -> None:
        with self._mu:
            self._acks[key] = value

    def _store_result(self, cache_key: "dict | None", env) -> None:
        """Publish one delivered envelope into the fleet cache under the
        ``(fingerprint, version-vector)`` the ENGINE stamped on it.
        When the router process itself holds one of those tables
        (in-process engines share the catalog), a version that moved
        since the stamp drops the store instead of publishing a dead
        entry."""
        if not cache_key or not self._result_cache.enabled:
            return
        fp = cache_key.get("fingerprint")
        vv = tuple(tuple(v) for v in cache_key.get("versions", ()))
        if fp is None or not vv:
            return
        from cylon_tpu_torch import catalog
        from cylon_tpu_torch.errors import KeyError_

        for tid, gen, dig in vv:
            try:
                cur = catalog.table_version(str(tid))
            except (KeyError, KeyError_):
                continue  # remote table: /events invalidation governs
            if (int(cur["generation"]) != int(gen)
                    or str(cur["digest"]) != str(dig)):
                return
        self._result_cache.store(fp, vv, env)
        with self._mu:
            self._vv_by_fp[fp] = vv

    def _acked(self, key: str) -> "tuple[bool, object]":
        with self._mu:
            if key in self._acks:
                return True, self._acks[key]
        return False, None

    def _record_failure(self, key: str, engine: str, error: str,
                        kind: str) -> None:
        with self._mu:
            self._failures[key] = {"engine": engine, "error": error,
                                   "kind": kind}

    def _failure(self, key: str) -> "dict | None":
        with self._mu:
            return self._failures.get(key)

    # ------------------------------------------------------- polling
    def _poll_loop(self, name: str) -> None:
        st = self._states[name]
        while not self._stop.is_set():
            if st.dead:
                return  # DEAD is terminal
            self._poll_one(st)
            self._stop.wait(self.poll_interval)

    def _poll_one(self, st: "_EngineState") -> None:
        """One cursor-loop tick against one engine: the /health verdict
        (with retry/backoff), the /events cursor advance and the
        windowed metrics view, inside the ``router_poll`` section."""
        with watchdog.watched_section("router_poll", detail=st.name):
            try:
                verdict = resilience.retrying(
                    st.client.health, self._retry_policy,
                    label=f"router_poll[{st.name}]")
            except Exception:
                self._note_failure(st.name, reason="health_poll")
                return
            try:
                ev = st.client.events_since(self._cursors[st.name])
                self._cursors[st.name] = ev.get(
                    "cursor", self._cursors[st.name])
                st.events_seen += len(ev.get("events", ()))
                gap = int(ev.get("dropped", 0) or 0)
                if gap:
                    # the engine's journal ring evicted entries before
                    # this poll read them: counted and journaled, never
                    # silent (a gap can hide an append)
                    telemetry.counter("fleet.events_gap",
                                      engine=st.name).inc(gap)
                    _events.emit("events_gap", engine=st.name,
                                 dropped=gap)
                # fleet-cache invalidation rides the same cursor
                for e in ev.get("events", ()):
                    if e.get("kind") == "append" and e.get("table"):
                        self._result_cache.invalidate_table(e["table"])
                if self._trace_armed:
                    self._pull_trace(st)
                st.last_window = st.client.metrics_window()
            except Exception:
                # the health verdict landed; a flaky events/window read
                # alone is not a liveness failure
                pass
        now = time.monotonic()
        with self._mu:
            st.verdict = verdict
            st.status = verdict.get("status", "unknown")
            st.failures = 0
            if st.status in ("unhealthy", "closing"):
                if st.unhealthy_since is None:
                    st.unhealthy_since = now
                dwell = now - st.unhealthy_since
            else:
                st.unhealthy_since = None
                dwell = 0.0
        if dwell > self.unhealthy_dwell:
            self._fail_over(st.name, reason=f"{st.status}_past_dwell")

    def _pull_trace(self, st: "_EngineState") -> None:
        """Advance one engine's ``/trace`` cursor (bounded like the
        source ring) and, once per engine, estimate its clock offset."""
        if st.clock_offset is None:
            st.clock_offset, st.offset_jitter = \
                self._clock_handshake(st.client)
        tr = st.client.trace_since(st.trace_cursor)
        st.trace_cursor = tr.get("cursor", st.trace_cursor)
        st.trace_dropped += int(tr.get("dropped", 0) or 0)
        st.trace_events.extend(tr.get("events", ()))
        del st.trace_events[:-_trace.DEFAULT_CAPACITY]

    @staticmethod
    def _clock_handshake(client,
                         probes: int = 5) -> "tuple[float, float]":
        """Estimate ``engine_clock - router_clock`` by the midpoint
        method: each ping reads the engine's wall ``ts`` between local
        stamps t0/t1, ``offset = ts - (t0 + t1)/2``; the probe with the
        smallest round trip wins and its half-RTT is the jitter. No
        usable probe: (0, 0)."""
        best = None
        for _ in range(max(int(probes), 1)):
            t0 = time.time()
            try:
                pong = client.ping()
            except Exception:
                continue
            t1 = time.time()
            ts = pong.get("ts")
            if not isinstance(ts, (int, float)):
                continue
            rtt = max(t1 - t0, 0.0)
            off = float(ts) - (t0 + t1) / 2.0
            if best is None or rtt < best[0]:
                best = (rtt, off)
        if best is None:
            return 0.0, 0.0
        return best[1], best[0] / 2.0

    def _failed_over(self, name: str, timeout: float) -> bool:
        """Wait up to ``timeout`` seconds for the failover of ``name`` to
        complete; False when the engine is still taken to be alive."""
        give_up = time.monotonic() + timeout
        while True:
            with self._mu:
                if any(f["engine"] == name for f in self._failovers):
                    return True
            if self._stop.is_set() or time.monotonic() > give_up:
                return False
            time.sleep(0.02)

    def _is_dead(self, name: "str | None") -> bool:
        with self._mu:
            st = self._states.get(name)
            return st is not None and st.dead

    def _note_failure(self, name: str, reason: str) -> None:
        with self._mu:
            st = self._states.get(name)
            if st is None or st.dead:
                return
            st.failures += 1
            tripped = st.failures >= self.fail_threshold
        if tripped:
            self._fail_over(name, reason=f"unreachable ({reason})")

    # ------------------------------------------------------- failover
    def _fail_over(self, name: str, reason: str) -> None:
        """Declare ``name`` dead and move its work: fence the journal,
        replay admitted-but-unresolved entries on a surviving peer
        (original idempotency keys — exactly once), re-point affected
        tickets. Idempotent: the first caller wins."""
        with self._mu:
            st = self._states.get(name)
            if st is None or st.dead:
                return
            st.dead = True
            st.status = "dead"
        detected = time.monotonic()
        telemetry.counter("fleet.failovers").inc()
        log = get_logger()
        log.warning("fleet: engine %r declared DEAD (%s); failing over",
                    name, reason)
        durable = st.client.durable_dir
        if durable:
            try:
                fence_journal(durable, owner=f"router:{os.getpid()}")
                _events.emit("fence", engine=name,
                             owner=f"router:{os.getpid()}")
                # the barrier on the router's trace track: victim quiet,
                # THE FENCE, then the survivor's replay hops
                _trace.instant("fleet.fence", cat="fleet", engine=name,
                               reason=reason)
            except OSError as e:  # pragma: no cover - fs failure
                log.error("fleet: could not fence %s: %s", durable, e)
        replayed, lost = self._replay_journal(st, durable)
        done_at = time.monotonic()
        with self._mu:
            self._failovers.append({
                "engine": name, "reason": reason,
                "replayed": replayed, "lost": lost,
                "detected_ts": detected, "completed_ts": done_at,
                "replay_s": done_at - detected})
        _events.emit("failover", engine=name, reason=reason,
                     replayed=replayed, lost=lost)
        log.warning("fleet: failover of %r complete — %d request(s) "
                    "replayed, %d lost", name, replayed, lost)

    def _unresolved_entries(self, durable: "str | None") -> \
            "tuple[list[dict], list[dict]]":
        """(replayable, unreplayable) journal entries the fleet still
        owes an answer for: the journal's incomplete set, plus entries
        that journaled done but whose result the ROUTER never delivered
        (the value died with the engine's memory, so exactly-once yields
        to never-lost and the entry re-executes under its key)."""
        if not durable:
            return [], []
        replayable, unreplayable = RequestJournal.incomplete(durable)
        have = {e.get("key") for e in replayable}
        with self._mu:
            undelivered = {
                k for k in self._tickets
                if k not in self._acks and k not in self._failures}
        for e in RequestJournal.read(durable):
            if e.get("kind") != "admit" or e.get("key") in have:
                continue
            if e.get("key") in undelivered:
                (replayable if e.get("replayable") and e.get("name")
                 else unreplayable).append(e)
                have.add(e.get("key"))
        return replayable, unreplayable

    def _replay_journal(self, dead: "_EngineState",
                        durable: "str | None") -> "tuple[int, int]":
        replayable, unreplayable = self._unresolved_entries(durable)
        replayed = lost = 0
        for e in unreplayable:
            # admitted (= acknowledged) but not expressible as a named
            # query: nothing can re-run it — counted, never silent
            lost += 1
            telemetry.counter("fleet.lost_acks",
                              tenant=e.get("tenant", "default")).inc()
            get_logger().error(
                "fleet: journal entry rid=%s on dead engine %r is "
                "unreplayable (bare callable / non-JSON args) — the "
                "acknowledged request is lost", e.get("rid"), dead.name)
        for e in replayable:
            key = e.get("key")
            with self._mu:
                if key is not None and (key in self._acks
                                        or key in self._failures):
                    continue  # outcome already delivered via router
            tenant = e.get("tenant", "default")
            # the replay keeps its ORIGINAL trace id (the dead engine's
            # journal recorded it at admission)
            tid = e.get("trace_id")
            try:
                with self._mu:
                    peer = self._pick_locked(tenant)
                with _trace.trace_context(tid):
                    rid = peer.client.submit(
                        e["name"], args=e.get("args", ()),
                        kwargs=e.get("kwargs", {}), tenant=tenant,
                        priority=e.get("priority", 1),
                        slo=e.get("slo"), key=key,
                        tables=e.get("tables", ()), trace_id=tid)
                    if tid is not None:
                        _trace.instant("fleet.replay_hop", cat="fleet",
                                       engine=peer.name, key=key)
            except Exception as exc:
                lost += 1
                get_logger().error(
                    "fleet: replay of %r from dead engine %r failed: %s",
                    key or e.get("rid"), dead.name, exc)
                t = self._tickets.get(key) if key is not None else None
                if t is not None:
                    t._mark_lost(
                        f"engine {dead.name!r} died and the replay on a "
                        f"peer failed: {exc}")
                else:  # journal-only entry: no ticket to carry it
                    telemetry.counter("fleet.lost_acks",
                                      tenant=tenant).inc()
                continue
            replayed += 1
            telemetry.counter("fleet.replayed", tenant=tenant).inc()
            with self._mu:
                self._replayed_keys.append(key)
                ticket = self._tickets.get(key)
            if ticket is not None:
                ticket._assign(peer.client, rid)
        # a router ticket still pointing at the dead engine with no
        # journal entry cannot exist (submit acks only after the
        # write-ahead line) — but mark any LOST rather than letting
        # result() spin forever
        with self._mu:
            stranded = [
                t for k, t in self._tickets.items()
                if k not in self._acks and k not in self._failures
                and t.engine == dead.name]
        for t in stranded:
            lost += 1
            t._mark_lost(f"engine {dead.name!r} died with no replayable "
                         "journal entry for this key")
        return replayed, lost

    # ------------------------------------------------------- report
    def report(self) -> dict:
        with self._mu:
            return {
                "engines": [s.snapshot() for s in self._states.values()],
                "tickets": len(self._tickets),
                "acked": len(self._acks),
                "failed": len(self._failures),
                "failovers": list(self._failovers),
                "replayed_keys": list(self._replayed_keys),
                "routed": telemetry.total("fleet.routed"),
                "deduped": telemetry.total("fleet.deduped"),
                "lost_acks": telemetry.total("fleet.lost_acks"),
            }

    def fleet_trace_buffers(self, drain: bool = True) -> "list[dict]":
        """Per-PROCESS trace buffers for
        :func:`cylon_tpu_torch.telemetry.trace.merge_timelines`: the
        router's own recorder (offset 0) plus every engine's pulled
        ``/trace`` segments on its handshake-estimated clock offset.
        ``drain`` pulls each engine's cursor once more first — call
        BEFORE :meth:`close` while survivors still answer."""
        with self._mu:
            states = list(self._states.values())
        if drain and self._trace_armed:
            for st in states:
                try:
                    self._pull_trace(st)
                except Exception:
                    pass  # dead engine: keep what the polls got
        bufs = [{"proc": "router", "pid": os.getpid(),
                 "clock_offset": 0.0, "offset_jitter": 0.0,
                 "dropped": _trace.dropped(), "events": _trace.events()}]
        for st in states:
            bufs.append({
                "proc": st.name,
                "pid": getattr(st.client, "pid", None),
                "clock_offset": st.clock_offset or 0.0,
                "offset_jitter": st.offset_jitter,
                "dropped": st.trace_dropped,
                "events": list(st.trace_events)})
        return bufs


# ----------------------------------------------------- engine process
def _mk_fleet_query(cq, resident, env):
    """A registered named query for one fleet engine: step 1 runs the
    compiled query, step 2 brings the result to the host (the staged
    shape :mod:`serve.bench` uses, so requests interleave).

    (port of ``cylon_tpu/serve/fleet.py`` ``_mk_fleet_query``)"""

    def run():
        out = cq(resident, env=env)
        yield
        return _materialize(out)

    return run


def _mk_fleet_fallback(query: str, data, env):
    """The registered spill path for one fleet query: the partitioned
    eager fallback on ``env``'s device (the two-phase plan for global
    aggregates like q14). Registered — not per submit — so a journal
    REPLAY after a failover re-arms it: a replayed request that runs out
    of memory on the survivor recomputes its merge scalar there.

    (port of ``cylon_tpu/serve/fleet.py`` ``_mk_fleet_fallback``)"""
    from cylon_tpu_torch import fallback

    def run():
        # eager per partition: the spill path must not re-enter the
        # compiled layer that just exhausted memory. The result is
        # already host-shaped, as _materialize gives the compiled path
        out = fallback.tpch_fallback(query, data, env=env, compiled=False)
        return out if hasattr(out, "columns") else float(out)

    return run


def _chaos_rules(kill: "str | None", oom: "str | None") -> list:
    """The chaos flags as fault rules: ``kill="point:nth"`` hard-kills
    the process (exit 43) at hit ``nth`` of ``point``; ``oom`` makes
    every hit from ``nth`` on raise ``MemoryError``, so each dispatch
    completes through its registered spill fallback."""
    rules = []
    if kill:
        point, nth = kill.rsplit(":", 1)
        rules.append(resilience.FaultRule.kill(point, nth=int(nth)))
    if oom:
        point, nth = oom.rsplit(":", 1)
        rules.append(resilience.FaultRule(
            point, nth=int(nth), times=0,
            error=MemoryError("injected OOM (--chaos-oom)")))
    return rules


def _engine_main(args) -> int:
    """One fleet engine process: resident TPC-H tables on its device,
    named queries registered for the gateway, durable dir at
    ``<root>/engines/<name>`` over the shared snapshot store. Prints one
    ``FLEET_ENGINE_READY {json}`` line (with its set-up seconds by
    stage), then serves until SIGTERM/SIGINT: a clean close releases the
    journal lock and logs ``FLEET_ENGINE_LAUNCHES {json}`` to stderr.
    ``--device cuda`` (the default) with no CUDA device dies before
    READY; nothing falls back to the CPU.

    (port of ``cylon_tpu/serve/fleet.py`` ``_engine_main``)"""
    os.environ.setdefault("CYLON_TPU_SERVE_HTTP_PORT", "0")

    import cylon_tpu_torch as ct
    from cylon_tpu_torch import catalog, kernels, tpch
    from cylon_tpu_torch.device import resolve
    from cylon_tpu_torch.serve import ServeEngine, introspect

    dev = resolve(args.device)
    introspect.STALL_AGE_S = float(args.stall_age)
    rules = _chaos_rules(args.chaos_kill, args.chaos_oom)
    if rules:
        resilience.install(resilience.FaultPlan(rules))

    mix = tuple(q.strip() for q in args.mix.split(",") if q.strip())
    layout = FleetLayout(args.root)
    env = ct.CylonEnv(device=dev)
    setup = {}
    t = time.perf_counter()
    data = tpch.generate(args.sf, args.seed, keep=_mix_keep(mix))
    setup["generate"] = time.perf_counter() - t
    t = time.perf_counter()
    resident = _mk_resident(env, data)
    if dev.type == "cuda":
        import torch

        torch.cuda.synchronize()
    setup["ingest"] = time.perf_counter() - t
    t = time.perf_counter()
    engine = ServeEngine(env, durable_dir=layout.engine_dir(args.name),
                         snapshot_dir=layout.snapshot_dir)
    for nm, df in resident.items():
        engine.register_table(f"tpch/{nm}", df)
    setup["snapshot"] = time.perf_counter() - t
    # the version vectors' digests, once, before READY: a cached query's
    # first request would otherwise hash its tables on the host
    t = time.perf_counter()
    for nm in resident:
        catalog.table_version(f"tpch/{nm}")
    setup["digests"] = time.perf_counter() - t
    for q in mix:
        reads = QUERY_READ_SETS.get(q, tuple(resident))
        engine.register_query(
            q, _mk_fleet_query(tpch.compiled(q), resident, env),
            fallback=_mk_fleet_fallback(q, data, env),
            tables=[f"tpch/{nm}" for nm in reads if nm in resident])
    gateway = EngineGateway(engine, port=args.gateway_port)
    kernels.reset_launches()
    ready = {"name": args.name, "pid": os.getpid(),
             "gateway": list(gateway.address),
             "introspect": (list(engine.http_address)
                            if engine.http_address else None),
             "durable_dir": engine.durable_dir, "mix": list(mix),
             "device": str(dev), "setup_s": setup}
    print("FLEET_ENGINE_READY " + json.dumps(ready), flush=True)

    stop = threading.Event()
    for sig in (signal.SIGTERM, signal.SIGINT):
        signal.signal(sig, lambda *a: stop.set())
    while not stop.is_set():
        stop.wait(0.5)
    engine.close(wait=True)
    gateway.close()
    print("FLEET_ENGINE_LAUNCHES " + json.dumps(kernels.launch_counts()),
          file=sys.stderr, flush=True)
    return 0


class EngineProc:
    """A spawned fleet engine process + its router-side client.
    ``ready`` is the child's READY line (its set-up seconds by stage
    under ``setup_s``).

    (port of ``cylon_tpu/serve/fleet.py`` ``EngineProc``)"""

    def __init__(self, name: str, proc, client: HttpEngineClient,
                 log_path: str, ready: "dict | None" = None):
        self.name = name
        self.proc = proc
        self.client = client
        self.log_path = log_path
        self.ready = ready or {}

    @property
    def pid(self) -> int:
        return self.proc.pid

    def kill(self, sig=signal.SIGKILL) -> None:
        """The chaos hammer: SIGKILL by default — no cleanup, no lock
        release, exactly like a preemption."""
        os.kill(self.proc.pid, sig)

    def terminate(self, timeout: float = 60.0) -> "int | None":
        if self.proc.poll() is None:
            self.proc.terminate()
        try:
            return self.proc.wait(timeout)
        except subprocess.TimeoutExpired:
            self.proc.kill()
            return self.proc.wait(10)

    def launches(self) -> "dict | None":
        """The kernel launches the child logged at its clean close;
        None when it never closed cleanly (killed, or still running)."""
        try:
            with open(self.log_path) as f:
                lines = [ln for ln in f
                         if ln.startswith("FLEET_ENGINE_LAUNCHES ")]
        except OSError:
            return None
        return json.loads(lines[-1].split(" ", 1)[1]) if lines else None


def _package_root() -> str:
    """The directory holding the ``cylon_tpu_torch`` package."""
    return os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))


def spawn_engine(root: str, name: str, sf: float = 0.002,
                 seed: int = 0, mix=DEFAULT_MIX,
                 env_extra: "dict | None" = None,
                 ready_timeout: float = 300.0, *, device="cuda",
                 chaos_kill: "str | None" = None,
                 chaos_oom: "str | None" = None) -> EngineProc:
    """Spawn ``python -m cylon_tpu_torch.serve.fleet`` as one engine
    process on ``device`` under ``root`` and wait for its READY line.
    A fresh interpreter, never a fork: the parent may hold a CUDA
    context. On CUDA the kernel library is built here first, so the
    child loads it instead of spending ``ready_timeout`` on ``nvcc``.
    The child's stderr streams to ``<root>/<name>.log``; stdout is
    drained by a daemon thread after the handshake. ``chaos_kill`` /
    ``chaos_oom`` (``"point:nth"``) arm the child's fault rules
    (:func:`_chaos_rules`).

    (port of ``cylon_tpu/serve/fleet.py`` ``spawn_engine``)"""
    import torch

    if torch.device(device).type == "cuda":
        from cylon_tpu_torch.kernels import build

        build.library()
    os.makedirs(root, exist_ok=True)
    log_path = os.path.join(root, f"{name}.log")
    cmd = [sys.executable, "-m", "cylon_tpu_torch.serve.fleet",
           "--root", str(root), "--name", str(name),
           "--sf", str(sf), "--seed", str(seed),
           "--mix", ",".join(mix), "--device", str(device),
           "--stall-age", str(ENGINE_STALL_AGE_S)]
    if chaos_kill:
        cmd += ["--chaos-kill", str(chaos_kill)]
    if chaos_oom:
        cmd += ["--chaos-oom", str(chaos_oom)]
    child_env = dict(os.environ)
    child_env.setdefault("CYLON_TPU_SERVE_HTTP_PORT", "0")
    child_env.setdefault("CYLON_TPU_EVENTS", "1")
    child_env["PYTHONPATH"] = os.pathsep.join(
        p for p in (_package_root(), child_env.get("PYTHONPATH")) if p)
    child_env.update(env_extra or {})
    logf = open(log_path, "ab")
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=logf,
                            env=child_env, text=True)
    logf.close()  # the child holds its own descriptor now

    # the handshake read rides a daemon reader thread so ready_timeout
    # is enforced; the same thread keeps draining stdout afterwards
    import queue as _queue

    lines: "_queue.Queue" = _queue.Queue(maxsize=1024)

    def _reader():
        for line in proc.stdout:
            try:
                lines.put_nowait(line)
            except _queue.Full:  # post-handshake chatter: discard
                pass
        try:
            lines.put_nowait(None)  # EOF sentinel
        except _queue.Full:
            pass

    threading.Thread(target=_reader, daemon=True,
                     name=f"fleet-spawn-{name}").start()
    deadline = time.monotonic() + ready_timeout
    ready = None
    while ready is None:
        remaining = deadline - time.monotonic()
        if remaining <= 0:
            proc.kill()
            proc.wait(10)
            raise EngineUnavailable(
                f"fleet engine {name!r} never reported READY within "
                f"{ready_timeout}s; see {log_path}")
        try:
            line = lines.get(timeout=min(remaining, 1.0))
        except _queue.Empty:
            continue
        if line is None:
            rc = proc.wait(10)
            raise EngineUnavailable(
                f"fleet engine {name!r} died before READY (rc={rc}); "
                f"see {log_path}")
        if line.startswith("FLEET_ENGINE_READY "):
            ready = json.loads(line.split(" ", 1)[1])
    client = HttpEngineClient(
        name, gateway_url="http://%s:%d" % tuple(ready["gateway"]),
        introspect_url=("http://%s:%d" % tuple(ready["introspect"])
                        if ready.get("introspect") else None),
        durable_dir=ready["durable_dir"], pid=ready["pid"])
    return EngineProc(name, proc, client, log_path, ready)


# ----------------------------------------------------- fleet bench
def _phase_p99s(samples: "list[tuple[float, float, float]]",
                kill_ts: "float | None",
                recovered_ts: "float | None") -> dict:
    """p99 request walls by phase relative to the outage window
    ``[kill_ts, recovered_ts]``: *before* = completed before the kill,
    *during* = the request's lifetime overlapped the outage, *after* =
    submitted after the failover completed. ``samples`` are (start,
    end, wall) triples; phases with no population report None.

    (port of ``cylon_tpu/serve/fleet.py`` ``_phase_p99s``)"""
    import numpy as np

    def p99(walls):
        if not walls:
            return None
        return float(np.quantile(np.asarray(walls), 0.99))

    if kill_ts is None:
        return {"before": p99([w for _, _, w in samples]),
                "during": None, "after": None}
    hi = recovered_ts if recovered_ts is not None else kill_ts
    return {
        "before": p99([w for s, e, w in samples if e < kill_ts]),
        "during": p99([w for s, e, w in samples
                       if e >= kill_ts and s <= hi]),
        "after": p99([w for s, e, w in samples if s > hi]),
    }


def audit_double_executions(layout: FleetLayout,
                            replayed_keys) -> "tuple[int, dict]":
    """Cross-journal exactly-once audit: a key with more than one
    ``done(state=done)`` line across the fleet's journals executed more
    than once. Keys the router knowingly re-executed (a completed result
    that died undelivered) are excluded; everything else is a real
    double execution.

    (port of ``cylon_tpu/serve/fleet.py`` ``audit_double_executions``)"""
    done_counts: "dict[str, int]" = {}
    for name in layout.engine_names():
        for e in RequestJournal.read(layout.engine_dir(name)):
            if e.get("kind") == "done" and e.get("state") == "done" \
                    and e.get("key"):
                done_counts[e["key"]] = done_counts.get(e["key"], 0) + 1
    allowed = set(k for k in (replayed_keys or ()) if k)
    doubles = {k: n for k, n in done_counts.items()
               if n > 1 and k not in allowed}
    return len(doubles), doubles


def _fleet_trace_artifact(router: "FleetRouter", root: str) -> dict:
    """Collect and stitch the fleet's per-process trace buffers (call
    BEFORE the router closes) and write the Chrome trace under ``root``.
    Returns the ``--fleet-trace`` record fields
    (:data:`REQUIRED_FLEET_TRACE_FIELDS`) plus the stitched report of
    the headline request: the replayed trace surviving on the MOST
    process tracks, or the busiest trace when nothing replayed.

    (port of ``cylon_tpu/serve/fleet.py`` ``_fleet_trace_artifact``)"""
    from cylon_tpu_torch.telemetry.export import write_chrome_trace

    bufs = router.fleet_trace_buffers()
    merged = _trace.merge_timelines(bufs)
    path = write_chrome_trace(
        os.path.join(root, "fleet_trace.trace.json"), bufs)
    jitters = [b.get("offset_jitter") for b in bufs[1:]
               if isinstance(b.get("offset_jitter"), (int, float))]
    hops = [e for e in merged if e.get("name") == "fleet.replay_hop"]
    hop_tids = sorted({e.get("trace_id") for e in hops
                       if e.get("trace_id")})
    stitched = None
    if hop_tids:
        def _coverage(tid):
            evs = [e for e in merged if e.get("trace_id") == tid]
            return (len({e.get("proc") for e in evs}), len(evs))

        best = max(sorted(hop_tids), key=_coverage)
        stitched = _trace.fleet_request_report(merged, best)
    else:
        by_tid: "dict[str, int]" = {}
        for e in merged:
            t = e.get("trace_id")
            if t:
                by_tid[t] = by_tid.get(t, 0) + 1
        if by_tid:
            top = max(sorted(by_tid), key=lambda t: by_tid[t])
            stitched = _trace.fleet_request_report(merged, top)
    return {
        "trace_path": path,
        "spans": sum(1 for e in merged if e.get("kind") == "begin"),
        "engines_stitched": sum(1 for b in bufs[1:] if b.get("events")),
        "offset_jitter_s": (round(max(jitters), 6) if jitters else None),
        "replay_hops": len(hops),
        "trace_dropped": sum(int(b.get("dropped", 0) or 0) for b in bufs),
        "stitched_request": stitched,
    }


def _fleet_history_check(layout: FleetLayout, mix) -> dict:
    """Audit the query-profile cost model against the run it learned
    from: merge the engines' persisted histories (a clean close saves
    ``profile_history.json``; a SIGKILLed engine never did) and compare
    each mix query's ``predicted_wall_s`` with the mean of its executed
    walls (within 2x).

    (port of ``cylon_tpu/serve/fleet.py`` ``_fleet_history_check``)"""
    from cylon_tpu_torch.telemetry import profile as _profile

    paths = [os.path.join(layout.engine_dir(n), _profile.HISTORY_FILE)
             for n in layout.engine_names()]
    paths = [p for p in paths if os.path.exists(p)]
    hist = _profile.merged_history(paths)
    checks: "dict[str, dict | None]" = {}
    for q in mix:
        # fleet queries take no arguments: the engine-side fingerprint
        # is the canonical hash over (name, (), {})
        fp = plan.query_fingerprint(q, (), {})
        est = hist.predict(fp) if fp is not None else None
        if est is None or not est.get("samples"):
            checks[q] = None
            continue
        mean = float(est["mean_wall_s"])
        pred = float(est["predicted_wall_s"])
        checks[q] = {
            "predicted_wall_s": round(pred, 4),
            "actual_mean_wall_s": round(mean, 4),
            "samples": est["samples"],
            "within_2x": bool(mean > 0 and 0.5 <= pred / mean <= 2.0),
        }
    return {"history_files": len(paths), "queries": checks}


def _fleet_oracles(sf: float, seed: int, mix, device) -> dict:
    """Each mix query once, alone, on tables of its own on ``device``:
    the results every fleet-routed request must reproduce."""
    import cylon_tpu_torch as ct
    from cylon_tpu_torch import tpch

    env = ct.CylonEnv(device=device)
    resident = _mk_resident(env, tpch.generate(sf, seed,
                                               keep=_mix_keep(mix)))
    return {q: _materialize(tpch.compiled(q)(resident, env=env))
            for q in mix}


def value_digest(v) -> str:
    """sha256 of a result's :func:`encode_value` envelope: equal digests
    are equal values bit for bit (floats travel as their exact repr)."""
    return hashlib.sha256(json.dumps(
        encode_value(v), sort_keys=True).encode()).hexdigest()


def run_fleet_bench(clients: int = 16, requests: int = 3,
                    sf: float = 0.002, seed: int = 0,
                    mix=DEFAULT_MIX, engines: int = 2,
                    kill_mid_run: bool = True,
                    root: "str | None" = None,
                    result_timeout: float = 600.0,
                    fleet_trace: bool = False, device="cuda") -> dict:
    """The fleet acceptance: ``engines`` engine processes on ``device``
    over one durable tree, ``clients`` concurrent clients replaying the
    TPC-H mix through the router, and once about a third of the
    requests completed, the next engine to acknowledge a request
    SIGKILLed right after it did. Every acknowledged ticket must complete
    oracle-exact (0 lost acks), nothing may double-execute, and the
    record carries the p99 before / during / after the kill, each
    engine's set-up by stage, the failover's detect and replay seconds
    and each oracle's :func:`value_digest`. The engines start together
    while this process computes the oracles. Returns the record
    (:data:`REQUIRED_FLEET_FIELDS` of :mod:`serve.bench`). ``root``
    defaults to a fresh temporary directory.

    (port of ``cylon_tpu/serve/fleet.py`` ``run_fleet_bench``)"""
    import concurrent.futures as cf
    import tempfile

    from cylon_tpu_torch.device import resolve

    if engines < 2:
        raise InvalidArgument(f"a fleet needs >= 2 engines, got {engines}")
    if fleet_trace:
        # arm the flight recorder fleet-wide: this (router) process plus
        # every spawned engine (the env it inherits, and explicitly)
        os.environ["CYLON_TPU_TRACE"] = "1"
    root = root or tempfile.mkdtemp(prefix="cylon_fleet_")
    layout = FleetLayout(root)
    mix = tuple(mix)

    # every spawned engine is terminated on ANY exit path
    procs: "list[EngineProc]" = []
    router = None
    try:
        t = time.perf_counter()
        with cf.ThreadPoolExecutor(engines) as ex:
            futs = [ex.submit(
                spawn_engine, root, f"e{i}", sf=sf, seed=seed, mix=mix,
                env_extra={"CYLON_TPU_TRACE": "1"} if fleet_trace
                else None, device=device)
                for i in range(engines)]
            try:
                # the oracles, meanwhile: each mix query once, alone, in
                # THIS process
                t_o = time.perf_counter()
                oracles = _fleet_oracles(sf, seed, mix, device)
                oracle_s = time.perf_counter() - t_o
            finally:
                failed = []
                for f in futs:
                    try:
                        procs.append(f.result())
                    except Exception as e:  # noqa: BLE001 - re-raised
                        failed.append(e)
            if failed:
                raise failed[0]
        spawn_s = time.perf_counter() - t
        # SIGKILL detection rides connection-refused polls (threshold 3
        # at 0.25 s); the dwell only governs verdict-based failover and
        # is generous, so a saturated host is not read as an outage. The
        # router's result cache is off for the run: with it, the mix's
        # repeats stop reaching the engines after their first sweep, and
        # a kill mid-run would find no request to fail over (the hot-mix
        # leg measures the cache)
        router = FleetRouter([p.client for p in procs],
                             poll_interval=0.25, fail_threshold=3,
                             unhealthy_dwell=45.0, cache_bytes=0)
        router.wait_for_verdicts()
        record = _drive_fleet_bench(
            router, procs, layout, oracles, clients=clients,
            requests=requests, sf=sf, mix=mix,
            kill_mid_run=kill_mid_run, root=root,
            result_timeout=result_timeout, fleet_trace=fleet_trace)
        record.update(device=str(resolve(device)),
                      oracle_s=oracle_s, spawn_s=spawn_s,
                      oracle_digests={q: value_digest(v)
                                      for q, v in oracles.items()},
                      engine_setup_s={p.name: p.ready.get("setup_s")
                                      for p in procs},
                      engine_launches={p.name: p.launches()
                                       for p in procs})
        return record
    finally:
        if router is not None:
            router.close()
        for p in procs:
            try:
                p.terminate()
            except Exception:  # pragma: no cover - teardown best-effort
                pass


def _drive_fleet_bench(router, procs, layout, oracles, *, clients,
                       requests, sf, mix, kill_mid_run, root,
                       result_timeout, fleet_trace=False) -> dict:
    """The measured body of :func:`run_fleet_bench` (the engines' and
    router's lifecycle owned by the caller's try/finally).

    (port of ``cylon_tpu/serve/fleet.py`` ``_drive_fleet_bench``)"""
    t0 = time.perf_counter()
    samples: "list[tuple[float, float, float]]" = []  # (start, end, wall)
    mismatches: list = []
    errors: list = []
    completed = [0]
    shed = [0]
    lock = threading.Lock()
    kill_ts = [None]
    victim = [None]
    total = clients * requests
    kill_at = max(total // 3, 1)  # after ~1/3 of acks land

    def client_thread(i: int):
        # sequential submit→result per client (one outstanding request
        # each): submissions spread across the whole run, so the
        # before/during/after populations all exist
        tenant = f"tenant{i}"
        for r in range(requests):
            q = mix[(i + r) % len(mix)]
            key = f"c{i}-r{r}"
            try:
                tk = router.submit(q, tenant=tenant, idempotency_key=key)
                got = tk.result(result_timeout)
            except Exception as e:
                with lock:
                    if isinstance(e, (ResourceExhausted,
                                      EngineUnavailable)):
                        shed[0] += 1
                    errors.append((key, f"{type(e).__name__}: {e}"))
                continue
            end = time.monotonic()
            with lock:
                samples.append((tk.submitted, end, end - tk.submitted))
                completed[0] += 1
                if completed[0] >= kill_at:
                    armed.set()  # before this client's next submit
            if not _results_match(got, oracles[q]):
                with lock:
                    mismatches.append((key, q))

    armed = threading.Event()
    kill_mu = threading.Lock()

    def killing(p):
        """``p``'s client, whose submits kill ``p`` once the run is
        armed: right after ``p`` acknowledged a request, so the engine
        dies owing it (a round-robin engine retires a sweep's requests
        together, so a kill timed by completions alone can land when the
        victim owes nothing)."""
        real = p.client.submit

        def submit(*args, **kwargs):
            rid = real(*args, **kwargs)
            if armed.is_set():
                with kill_mu:
                    if victim[0] is None:
                        victim[0] = p
                        kill_ts[0] = time.monotonic()
                        get_logger().warning(
                            "fleet bench: SIGKILL engine %r (pid %d) "
                            "mid-run, right after it acknowledged a "
                            "request", p.name, p.pid)
                        p.kill()
            return rid

        return submit

    threads = [threading.Thread(target=client_thread, args=(i,),
                                name=f"fleet-client-{i}")
               for i in range(clients)]
    if kill_mid_run:
        for p in procs:
            p.client.submit = killing(p)
    for th in threads:
        th.start()
    for th in threads:
        th.join()
    wall = time.perf_counter() - t0
    if kill_ts[0] is not None:
        # the clients may finish before the polls declare the victim
        # dead (its tenants re-route on a refused connection): the
        # record reads the failover, so wait for it
        give_up = time.monotonic() + FAILOVER_WAIT_S
        while not router._is_dead(victim[0].name) \
                and time.monotonic() < give_up:
            time.sleep(0.05)

    rep = router.report()
    recovered_ts = (rep["failovers"][0]["completed_ts"]
                    if rep["failovers"] else None)

    # the post-failover idempotent-retry probe: a completed key
    # re-submitted through the router comes back from the ack ledger
    # without executing anywhere
    retry_deduped = None
    if samples:
        before = telemetry.total("fleet.deduped")
        try:
            router.submit(mix[0], tenant="tenant0",
                          idempotency_key="c0-r0").result(30)
            retry_deduped = telemetry.total("fleet.deduped") > before
        except Exception as e:  # pragma: no cover - probe best-effort
            retry_deduped = False
            errors.append(("retry_probe", f"{type(e).__name__}: {e}"))

    # the stitched trace wants live survivors (the final cursor drain)
    trace_extra = (_fleet_trace_artifact(router, root)
                   if fleet_trace else None)
    # stop the poll loops BEFORE terminating survivors (a running poll
    # would read the graceful shutdown as one more failover), then stop
    # the engines so their journals are quiescent to audit
    router.close()
    for p in procs:
        p.terminate()
    doubles, double_detail = audit_double_executions(
        layout, rep["replayed_keys"])
    record = {
        "metric": "fleet_bench_tpch_mix",
        "engines": len(procs),
        "clients": clients,
        "requests_total": total,
        "completed": completed[0],
        "shed": shed[0],
        "wall_s": round(wall, 3),
        "sf": sf,
        "mix": list(mix),
        "kill": ("sigkill_mid_run" if kill_mid_run else None),
        "victim": victim[0].name if victim[0] is not None else None,
        "failovers": len(rep["failovers"]),
        "failover_detail": [
            {k: v for k, v in f.items()
             if k not in ("completed_ts", "detected_ts")}
            for f in rep["failovers"]],
        # from the SIGKILL to the router declaring the engine dead
        "detect_s": (rep["failovers"][0]["detected_ts"] - kill_ts[0]
                     if rep["failovers"] and kill_ts[0] is not None
                     else None),
        "replayed": telemetry.total("fleet.replayed"),
        "lost_acks": rep["lost_acks"],
        "routed": rep["routed"],
        "deduped": rep["deduped"],
        "retry_deduped": retry_deduped,
        "double_executions": doubles,
        "double_execution_detail": double_detail,
        "oracle_mismatches": len(mismatches),
        "mismatch_detail": mismatches[:8],
        "errors": len(errors),
        "error_detail": errors[:8],
        "p99_before_s": None,
        "p99_during_s": None,
        "p99_after_s": None,
        "fleet_root": root,
        # the shared store's per-table generation stamps (engines are
        # down): what a failover recover() would restore
        "table_generations": snapshot_generations(root),
    }
    phases = _phase_p99s(samples, kill_ts[0], recovered_ts)
    record.update(p99_before_s=phases["before"],
                  p99_during_s=phases["during"],
                  p99_after_s=phases["after"])
    if trace_extra is not None:
        record.update(trace_extra)
        # the engines just closed cleanly (SIGTERM → engine.close saves
        # profile_history.json): audit the cost model
        record["cost_model"] = _fleet_history_check(layout, mix)
    return record


# ----------------------------------------------------------- __main__
def main(argv=None) -> int:
    p = argparse.ArgumentParser(
        description="run ONE fleet engine process (the fleet bench and "
                    "the chaos tests spawn these; to drive a fleet run "
                    "`python -m cylon_tpu_torch.serve.bench --fleet`)")
    p.add_argument("--root", required=True,
                   help="fleet durable root (FleetLayout)")
    p.add_argument("--name", required=True, help="engine name")
    p.add_argument("--sf", type=float, default=0.002)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--mix", default=",".join(DEFAULT_MIX))
    p.add_argument("--device", default="cuda",
                   help="the engine's device (default cuda; a CUDA "
                        "engine with no device dies before READY)")
    p.add_argument("--gateway-port", type=int, default=0)
    p.add_argument("--stall-age", type=float, default=ENGINE_STALL_AGE_S,
                   help="seconds without a scheduler step before /health "
                        "reads a stall (serve.introspect.STALL_AGE_S)")
    p.add_argument("--chaos-kill", default=None, metavar="POINT:NTH",
                   help="hard-kill (exit 43) at hit NTH of fault POINT")
    p.add_argument("--chaos-oom", default=None, metavar="POINT:NTH",
                   help="raise MemoryError at every hit of POINT from NTH")
    return _engine_main(p.parse_args(argv))


if __name__ == "__main__":
    sys.exit(main())
