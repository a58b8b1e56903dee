"""cylon_tpu_torch.telemetry — unified metrics: registry, exporters,
world view (port of ``cylon_tpu/telemetry``).

One process-local, thread-safe registry of typed instruments
(:class:`Counter` / :class:`Gauge` / :class:`Histogram` /
:class:`Timer`) with label support. It is the port's own registry:
a process that imports both packages holds two, separate. Hot layers
instrument through module helpers::

    from cylon_tpu_torch import telemetry

    telemetry.counter("exchange.bytes_true", op="dist_join").inc(nb)
    with telemetry.timer("barrier.wait_seconds").time():
        ...
    snap = telemetry.snapshot()          # in-process, for tests
    world = telemetry.gather_metrics(env)  # merged across processes

Design contract: with no exporter configured —
``CYLON_TPU_METRICS_DIR`` unset — instrumentation is dict updates only;
no thread starts, no file opens. Exporters
(:mod:`cylon_tpu_torch.telemetry.export`): JSONL snapshot lines + a
Prometheus text dump per process, armed lazily off the env knob.

:mod:`cylon_tpu_torch.telemetry.memory` keeps the device-memory
live-bytes gauges, per-op peak watermarks and OOM forensics; its OOM
report names the largest resident tables of
:mod:`cylon_tpu_torch.catalog`. :mod:`cylon_tpu_torch.telemetry.profile`
holds the per-query EXPLAIN plans and the per-request ANALYZE profiles
that the serve engine's ``QueryTicket.profile()`` renders.

The event-level half is :mod:`cylon_tpu_torch.telemetry.trace` — the
``CYLON_TPU_TRACE`` flight recorder: per-rank span/instant/counter
timelines, Chrome Trace export (:func:`to_chrome_trace` /
:func:`write_chrome_trace`), the rank buffers (:func:`gather_traces`;
``ThreadWorld`` ranks split by their rank stamp) merged by
``trace.merge_timelines``, and critical-path straggler attribution
(``trace.critical_path``). Same no-overhead-when-off contract.
"""

from cylon_tpu_torch.telemetry import (events, memory, profile, timeseries,
                                       trace)
from cylon_tpu_torch.telemetry.aggregate import (gather_metrics,
                                                 gather_traces,
                                                 merge_snapshots)
from cylon_tpu_torch.telemetry.export import (HBM_PEAK_BYTES_PER_SEC,
                                              NVLINK_BYTES_PER_SEC,
                                              REQUIRED_BENCH_KEYS,
                                              bench_metrics,
                                              chrome_trace_json,
                                              fraction_of_peak,
                                              json_safe,
                                              metrics_dir, snapshot_to_json,
                                              to_chrome_trace, to_prometheus,
                                              write_chrome_trace,
                                              write_snapshot)
from cylon_tpu_torch.telemetry.registry import (BUCKET_BOUNDS, Counter,
                                                Gauge, Histogram,
                                                MetricRegistry, Timer,
                                                add_record, counter,
                                                current_tenant, delta, gauge,
                                                get_records, histogram,
                                                instruments,
                                                merge_histograms, metric,
                                                registry, reset, snapshot,
                                                tenant_labels, tenant_scope,
                                                timer, total)

__all__ = [
    "BUCKET_BOUNDS", "Counter", "Gauge", "Histogram", "Timer",
    "MetricRegistry", "registry", "counter", "gauge", "histogram",
    "timer", "metric", "instruments", "snapshot", "delta", "reset",
    "total", "add_record", "get_records", "merge_snapshots",
    "gather_metrics", "gather_traces", "json_safe", "snapshot_to_json",
    "to_prometheus", "metrics_dir", "write_snapshot", "bench_metrics",
    "REQUIRED_BENCH_KEYS", "HBM_PEAK_BYTES_PER_SEC",
    "NVLINK_BYTES_PER_SEC", "fraction_of_peak", "trace",
    "to_chrome_trace", "chrome_trace_json", "write_chrome_trace",
    "tenant_scope", "current_tenant", "tenant_labels",
    "merge_histograms", "memory", "profile", "events", "timeseries",
]
