"""Package rules of the port: it never imports JAX or ``cylon_tpu``, it
defaults to CUDA without quietly dropping to the CPU, and every kernel
wrapper has a plain version, a launch counter and a row in ``PERF.md``."""

import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import cylon_tpu_torch
from cylon_tpu_torch import kernels
from cylon_tpu_torch.errors import DeviceUnavailable

ROOT = Path(__file__).resolve().parent.parent
PKG = ROOT / "cylon_tpu_torch"

_PROBE = """
import sys
import numpy as np
import cylon_tpu_torch as ct
t = ct.Table.from_pydict({"k": np.arange(10) % 3, "a": np.arange(10.0)},
                         device="cpu")
r = ct.join(t, t, on="k", out_capacity=100)
assert r.num_rows == 34, r.num_rows
env = ct.CylonEnv()
g = ct.dist_groupby(env, t, ["k"], [("a", "sum"), ("a", "median")])
assert g.num_rows == 3, g.num_rows
assert float(ct.dist_aggregate(env, t, "a", "sum")) == 45.0
assert ct.shuffle(env, t, ["k"]).num_rows == 10
assert ct.repartition(env, t).num_rows == 10
assert ct.groupby_aggregate(t, ["k"], [("a", "max")]).num_rows == 3
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "cylon_tpu"))
print("BAD", bad)
"""


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def test_import_and_join_pull_in_no_jax():
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def _imported_modules(path: Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def test_no_file_imports_jax_or_the_jax_package():
    files = sorted(PKG.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(files) > 10
    # the TPC-H subpackage keeps its own copies of the JAX package's
    # numpy-only generator and manifest
    for name in ("__init__", "dbgen", "manifest", "queries"):
        assert PKG / "tpch" / f"{name}.py" in files, name
    # and the telemetry package and utils keep their own copies of the
    # JAX package's backend-neutral modules
    for name in ("__init__", "registry", "events", "timeseries", "export",
                 "trace", "aggregate", "memory"):
        assert PKG / "telemetry" / f"{name}.py" in files, name
    for name in ("__init__", "logging", "tracing"):
        assert PKG / "utils" / f"{name}.py" in files, name
    # and the resilience, deadline and spill modules and their TPC-H
    # plans (ROADMAP A7.1, A7.2)
    for name in ("resilience", "watchdog", "pipeline", "outofcore",
                 "fallback"):
        assert PKG / f"{name}.py" in files, name
    for name in ("twophase", "streaming"):
        assert PKG / "tpch" / f"{name}.py" in files, name
    for path in files:
        for mod in _imported_modules(path):
            top = mod.split(".")[0]
            assert top not in ("jax", "jaxlib", "cylon_tpu"), \
                f"{path.relative_to(ROOT)} imports {mod}"


_TPCH_PROBE = """
import sys
import cylon_tpu_torch as ct
from cylon_tpu_torch import tpch
data = tpch.generate(0.001, 1)
frames = tpch.ingest(data, device="cpu")
assert len(tpch.q3(frames).to_pandas()) <= 10
assert float(tpch.compiled("q6")(frames)) == tpch.q6(frames)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "cylon_tpu"))
print("BAD", bad)
"""


def test_tpch_and_compiled_queries_pull_in_no_jax():
    out = subprocess.run([sys.executable, "-c", _TPCH_PROBE], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


_TELEMETRY_PROBE = """
import os
import sys
os.environ["CYLON_TPU_TRACE"] = "1"
import cylon_tpu_torch.telemetry as tel
from cylon_tpu_torch.utils import span, pow2_bucket
with span("probe", cat="stage"):
    tel.counter("probe.count").inc()
    tel.memory.sample(force=True)
assert [e["name"] for e in tel.trace.events()] == ["probe", "probe"]
assert pow2_bucket(5) == 8
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "cylon_tpu"))
print("BAD", bad)
"""


def test_telemetry_import_pulls_in_no_jax():
    out = subprocess.run([sys.executable, "-c", _TELEMETRY_PROBE], cwd=ROOT,
                         env=_env(), capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout


def test_telemetry_exports_the_jax_names():
    """The port's telemetry exports every name of the JAX package's but
    ``profile`` (EXPLAIN / ANALYZE, which waits for the catalog) and the
    TPU link rate, whose place the H100's NVLink data-sheet rate takes;
    its registry is its own."""
    import cylon_tpu.telemetry as jtel

    from cylon_tpu_torch import telemetry as tel

    assert "telemetry" in cylon_tpu_torch.__all__
    want = set(jtel.__all__) - {"profile", "ICI_LINK_BYTES_PER_SEC"}
    assert want | {"NVLINK_BYTES_PER_SEC"} == set(tel.__all__)
    for name in tel.__all__:
        assert getattr(tel, name) is not None, name
    assert tel.registry is not jtel.registry
    tel.counter("own.registry").inc()
    assert jtel.metric("own.registry") is None
    tel.reset("own.")


def test_default_device_is_cuda_and_never_falls_back(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(DeviceUnavailable):
        cylon_tpu_torch.Table.from_pydict({"a": [1, 2, 3]})
    with pytest.raises(DeviceUnavailable):
        cylon_tpu_torch.Table.from_pydict({"a": [1, 2, 3]}, device="cuda")
    t = cylon_tpu_torch.Table.from_pydict({"a": [1, 2, 3]}, device="cpu")
    assert t.device.type == "cpu" and t.num_rows == 3


def test_every_kernel_wrapper_has_plain_version_counter_and_perf_row():
    perf = (ROOT / "PERF.md").read_text()
    names = set()
    for w in kernels.WRAPPERS:
        names.add(w.__name__)
        assert callable(w.plain) and w.plain.__module__ == w.__module__
        assert isinstance(w.launches, int)
        assert (ROOT / w.source).is_file(), w.source
        assert f"`{w.__name__}`" in perf, f"{w.__name__} has no PERF.md row"
    # every public wrapper module of the package is registered
    for path in (PKG / "kernels").glob("*.py"):
        if path.stem in ("__init__", "build"):
            continue
        mod = __import__(f"cylon_tpu_torch.kernels.{path.stem}",
                         fromlist=["_"])
        for obj in vars(mod).values():
            if callable(obj) and hasattr(obj, "launches"):
                assert obj.__name__ in names, obj.__name__


def test_chip_smoke_refuses_to_run_without_a_card():
    env = _env()
    env["CUDA_VISIBLE_DEVICES"] = ""   # no card, whatever the host has
    out = subprocess.run([sys.executable, str(ROOT / "chip_smoke.py")],
                         cwd=ROOT, env=env, capture_output=True,
                         text=True, timeout=120)
    assert out.returncode != 0
    assert '"ok": true' not in out.stdout


#: the public functions of the port's group-by and exchange slice, each
#: the counterpart of a cylon_tpu function its docstring names
_COUNTERPARTS = (
    "cylon_tpu_torch.parallel.dist_ops:shuffle",
    "cylon_tpu_torch.parallel.dist_ops:repartition",
    "cylon_tpu_torch.parallel.dist_ops:dist_groupby",
    "cylon_tpu_torch.parallel.dist_ops:dist_aggregate",
    "cylon_tpu_torch.parallel.dist_ops:_tight_rows_local",
    "cylon_tpu_torch.parallel.dist_ops:_combine_plan",
    "cylon_tpu_torch.parallel.dist_ops:_sketch_quantile",
    "cylon_tpu_torch.parallel.dist_ops:_value_hash_tables",
    "cylon_tpu_torch.parallel.dist_ops:_value_partition_keys",
    "cylon_tpu_torch.ops.groupby:groupby_aggregate",
    "cylon_tpu_torch.ops.groupby:_groupby_compiled",
    "cylon_tpu_torch.ops.groupby:_aggregate_column",
    "cylon_tpu_torch.ops.groupby:_nunique",
    "cylon_tpu_torch.ops.groupby:_quantile",
    "cylon_tpu_torch.ops.aggregates:table_aggregate",
    "cylon_tpu_torch.ops.aggregates:_masked_quantile",
    "cylon_tpu_torch.ops.kernels:dense_group_ids",
    "cylon_tpu_torch.ops.kernels:segmented_totals",
    "cylon_tpu_torch.ops.partition:modulo_partition_ids",
    "cylon_tpu_torch.column:Dictionary.value_hashes",
    "cylon_tpu_torch.context:DistConfig",
    "cylon_tpu_torch.plan:regrow_eager",
    "cylon_tpu_torch.plan:capacity_scale",
    "cylon_tpu_torch.table:Table.shrink_to_fit",
    "cylon_tpu_torch.table:Table.from_arrow",
    "cylon_tpu_torch.config:JoinConfig",
    "cylon_tpu_torch.config:CSVReadOptions",
    "cylon_tpu_torch.config:ParquetOptions",
    "cylon_tpu_torch.io:_exchange_meta",
    "cylon_tpu_torch.series:_StrAccessor",
    # whole queries and TPC-H (ROADMAP A6)
    "cylon_tpu_torch.plan:CompiledQuery",
    "cylon_tpu_torch.plan:compile_query",
    "cylon_tpu_torch.plan:shared_compiled",
    "cylon_tpu_torch.plan:note_overflow",
    "cylon_tpu_torch.plan:_check_overflow",
    "cylon_tpu_torch.plan:_shrink_results",
    "cylon_tpu_torch.plan:_split_args",
    "cylon_tpu_torch.tpch.queries:_tables",
    "cylon_tpu_torch.tpch.queries:_prune",
    "cylon_tpu_torch.tpch.queries:_scalar",
    "cylon_tpu_torch.tpch.queries:manifest_keep",
    "cylon_tpu_torch.tpch.queries:keep_columns",
    "cylon_tpu_torch.tpch.queries:_query_strings",
    "cylon_tpu_torch.tpch.dbgen",
    "cylon_tpu_torch.tpch.manifest",
    # the telemetry core (ROADMAP A8.1)
    "cylon_tpu_torch.telemetry",
    "cylon_tpu_torch.telemetry.aggregate",
    "cylon_tpu_torch.telemetry.memory",
    "cylon_tpu_torch.utils.tracing",
    "cylon_tpu_torch.parallel.dist_ops:_stage",
    "cylon_tpu_torch.parallel.dist_ops:_note_exchange",
    "cylon_tpu_torch.plan:plan_cache_stats",
    "cylon_tpu_torch.plan:query_fingerprint",
    "cylon_tpu_torch.plan:CompiledQuery.invalidate",
    # resilience, deadlines and the spill path (ROADMAP A7.1, A7.2)
    "cylon_tpu_torch.resilience",
    "cylon_tpu_torch.watchdog",
    "cylon_tpu_torch.pipeline",
    "cylon_tpu_torch.outofcore",
    "cylon_tpu_torch.fallback",
    "cylon_tpu_torch.tpch.twophase",
    "cylon_tpu_torch.tpch.streaming",
    "cylon_tpu_torch.parallel.dist_ops:_account_exchange_rows",
    "cylon_tpu_torch.context:CylonEnv._bootstrap",
    "cylon_tpu_torch.context:CylonEnv.barrier",
    "cylon_tpu_torch.ops_graph.graph:chunk_stream",
)


@pytest.mark.parametrize("name", _COUNTERPARTS)
def test_new_function_names_its_cylon_tpu_counterpart(name):
    import importlib

    mod, _, attr = name.partition(":")
    obj = importlib.import_module(mod)
    for part in attr.split(".") if attr else ():
        obj = getattr(obj, part)
    assert "cylon_tpu/" in (obj.__doc__ or ""), name


def test_public_names_of_the_slice_are_exported():
    for name in ("shuffle", "repartition", "dist_groupby", "dist_aggregate",
                 "groupby_aggregate", "table_aggregate", "ProcessGroupComm",
                 "DistConfig", "LocalConfig",
                 # the user-facing layer (ROADMAP A5)
                 "DataFrame", "GroupByDataFrame", "Series", "merge",
                 "concat", "read_csv", "read_csv_sharded", "read_csv_chunks",
                 "read_parquet", "read_parquet_chunks", "read_json",
                 "write_csv", "write_csv_sharded", "write_parquet",
                 "CSVReadOptions", "CSVWriteOptions", "ParquetOptions",
                 "JoinConfig", "JoinType", "JoinAlgorithm", "IndexingType",
                 "LogicalTaskPlan", "task_shuffle", "task_tables",
                 "IndexError_", "IOError_",
                 # resilience, deadlines and the spill path (A7.1, A7.2)
                 "Code", "DataLossError", "DeadlineExceeded",
                 "DeadlinePolicy", "FailedPrecondition", "FaultPlan",
                 "FaultRule", "ResourceExhausted", "RetryPolicy",
                 "TransientError", "deadline", "pipeline"):
        assert name in cylon_tpu_torch.__all__, name
        assert getattr(cylon_tpu_torch, name) is not None
    import cylon_tpu

    # every one of them that the JAX package exports, it exports too
    for name in ("DataFrame", "Series", "merge", "concat", "read_csv",
                 "read_csv_sharded", "read_csv_chunks", "read_parquet_chunks",
                 "write_csv_sharded", "CSVReadOptions", "ParquetOptions",
                 "JoinConfig", "IndexingType", "FaultPlan", "FaultRule",
                 "RetryPolicy", "DeadlinePolicy", "deadline", "pipeline",
                 "TransientError", "DataLossError",
                 "DeadlineExceeded"):
        assert name in cylon_tpu.__all__, name


def test_chip_smoke_drives_the_frame_phase():
    """``chip_smoke.py`` names phase 13 in its docstring, runs it after
    phase 12, holds its kernels against their plain versions, and puts
    its launches in the kernels line."""
    src = (ROOT / "chip_smoke.py").read_text()
    tree = ast.parse(src)
    doc = ast.get_docstring(tree)
    assert "13. frame" in doc
    funcs = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert "frame_phase" in funcs
    main = src[src.index("def main("):]
    assert main.index("sort_setops_phase(") < main.index("frame_phase(") \
        < main.index('path_kernel_phase(torch, rate, stats, "frame"')
    assert '"frame_launches"' in main


def test_no_kernel_takes_the_pointer_of_a_temporary_tensor():
    """Every tensor whose pointer a wrapper hands its library outlives
    the call. ctypes releases the GIL during a foreign call, so a tensor
    made only to take its ``data_ptr()`` is freed before the launch, and
    another thread sharing the stream (a ThreadWorld rank) can take and
    write its memory between the kernel's passes: the scan32 scratch did
    so, and a W = 4 group-by on the card lost groups."""
    for path in sorted((PKG / "kernels").glob("*.py")):
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Attribute) and node.attr == "data_ptr" \
                    and isinstance(node.value, ast.Call):
                raise AssertionError(
                    f"{path.relative_to(ROOT)}:{node.lineno} takes the "
                    "pointer of a temporary tensor")


def test_chip_smoke_drives_the_tpch_phase():
    """``chip_smoke.py`` names phase 14 in its docstring, runs it after
    phase 13, holds its kernels against their plain versions, and puts
    its launches in the kernels line."""
    src = (ROOT / "chip_smoke.py").read_text()
    tree = ast.parse(src)
    assert "14. tpch" in ast.get_docstring(tree)
    funcs = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert "tpch_phase" in funcs
    main = src[src.index("def main("):]
    assert main.index("frame_phase(") < main.index("tpch_phase(") \
        < main.index('path_kernel_phase(torch, rate, stats, "tpch"')
    assert '"tpch_launches"' in main


def test_chip_smoke_drives_the_telemetry_phase():
    """``chip_smoke.py`` names phase 15 in its docstring, runs it after
    phase 14, holds its kernels against their plain versions, puts its
    launches in the kernels line, and ends every phase in a memory
    line."""
    src = (ROOT / "chip_smoke.py").read_text()
    tree = ast.parse(src)
    doc = ast.get_docstring(tree)
    assert "15. telemetry" in doc and "memory" in doc
    funcs = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert {"telemetry_phase", "memory_line", "count_syncs"} <= funcs
    main = src[src.index("def main("):]
    assert main.index("tpch_phase(") < main.index("telemetry_phase(")
    assert '"telemetry_launches"' in main
    body = src[src.index("def telemetry_phase("):src.index("def main(")]
    assert 'path_kernel_phase(torch, rate, stats, "telemetry"' in body
    for phase in range(1, 16):
        assert f'memory_line(torch, card, "{phase} ' in main, phase


def test_chip_smoke_drives_the_spill_phase():
    """``chip_smoke.py`` names phase 16 in its docstring, runs it after
    phase 15, holds its kernels against their plain versions, puts its
    launches in the kernels line, ends it in a memory line, and runs its
    killed child through its own ``--spill-child`` entry."""
    src = (ROOT / "chip_smoke.py").read_text()
    tree = ast.parse(src)
    assert "16. spill" in ast.get_docstring(tree)
    funcs = {n.name for n in tree.body if isinstance(n, ast.FunctionDef)}
    assert {"spill_phase", "spill_child", "spill_tables"} <= funcs
    main = src[src.index("def main("):]
    assert main.index("telemetry_phase(") < main.index("spill_phase(")
    assert '"spill_launches"' in main
    assert 'path_kernel_phase(torch, rate, stats, "spill"' in main
    assert 'memory_line(torch, card, "16 ' in main
    assert main.index('"--spill-child"') < main.index("is_available()")
    body = src[src.index("def spill_phase("):src.index("def main(")]
    for part in ("(a)", "(b)", "(c)", "(d)", "(e)", "(f)", "(g)"):
        assert f"    {part} " in body, part
