"""The parity inventory: the JAX package's public surface against the
port's, name by name, on the CPU.

For every module of ``cylon_tpu`` (``pkgutil.walk_packages``; a file that
does not import, such as the native library's ``.so``, is skipped) and
the package itself, every public function and class the module defines
or lists in ``__all__`` must exist at the same path in
``cylon_tpu_torch``, found by attribute lookup (a re-export counts, as
``config.SortOptions`` from ``parallel.dist_ops``). At a function's or
class's home (the module that defines it, under its own name) every
parameter name of the JAX function, method or constructor must be one
of the port's, and every public method, class attribute, dataclass
field and enum member of the JAX class must be the port's class's; a
re-export or an alias (``context.MPIConfig``) must exist.

The exceptions are :data:`DELIBERATE`, each with its reason and the
``ROADMAP.md`` item it rests on. A second case fails when an entry is
no longer a gap, so the table only shrinks: a gap that is closed leaves
it, and a new gap is either ported or recorded there.
"""

import enum
import importlib
import inspect
import pkgutil

import pytest

#: every module of ``cylon_tpu`` that imports, relative to the package
#: ("" is the package itself); ``test_the_module_list_is_the_jax_packages``
#: holds it against ``pkgutil.walk_packages``
MODULES = [
    "", "catalog", "column", "config", "context", "dtypes", "errors",
    "fallback", "frame", "indexing", "indexing.index", "indexing.indexer",
    "io", "native", "ops", "ops.aggregates", "ops.bytescol",
    "ops.datetime_ops", "ops.dictenc", "ops.groupby", "ops.hash",
    "ops.hash_join", "ops.join", "ops.kernels", "ops.pallas_kernels",
    "ops.partition", "ops.selection", "ops.setops", "ops_graph",
    "ops_graph.execution", "ops_graph.graph", "ops_graph.op", "outofcore",
    "parallel", "parallel.collectives", "parallel.dist_ops",
    "parallel.dtable", "parallel.shuffle", "parallel.task_plan",
    "pipeline", "plan", "platform", "resilience", "row", "series", "serve",
    "serve.admission", "serve.bench", "serve.durability", "serve.fleet",
    "serve.introspect", "serve.result_cache", "serve.service",
    "serve.session", "serve.slo", "table", "telemetry",
    "telemetry.aggregate", "telemetry.events", "telemetry.export",
    "telemetry.memory", "telemetry.profile", "telemetry.registry",
    "telemetry.timeseries", "telemetry.trace", "tpch", "tpch.dbgen",
    "tpch.manifest", "tpch.queries", "tpch.streaming", "tpch.twophase",
    "utils", "utils.logging", "utils.tracing", "views", "views.combiners",
    "views.materialized", "watchdog"]

_MESH = ("the topology lives on the communicator: an SPMD rank has no "
         "mesh, axis names or shardings", "A10")
_SHARDED = ("no mesh-sharded table: a rank holds its shard, and its "
            "count is a 0-d tensor", "A8.1")
_PADDED = ("the exchanges move exact counts (a count exchange first), "
           "so no padded per-peer bucket or middle buffer is sized",
           "A10")
_PYTREE = ("JAX pytree registration; the port's tables are never "
           "traced", "A13")
_ORDER_KEYS = ("the port's sorts are stable and take order keys "
               "(kernels.order_key) that carry each key's direction",
               "A13")
_PAYLOADS = ("JAX's payload-or-gather crossover was a TPU measurement; "
             "the port gathers", "Left from done slices")
_ROW_HINT = ("the row hint is not ported: the exchanges size from real "
             "counts", "Left from done slices")
_SWITCHES = ("no CYLON_TPU_ADAPTIVE / CYLON_TPU_TIGHT switch: the ladders "
             "and tight sizing are always on", "Left from done slices")

#: ``path -> (reason, ROADMAP.md item)``: the JAX names the port leaves
#: out on purpose. A path is ``module.name``, ``module.Class.member`` or
#: ``module.function(parameter=)``; a whole module is its path alone.
DELIBERATE = {
    "ops.pallas_kernels": ("the five Pallas kernels are CUDA C++ in "
                           "cylon_tpu_torch/csrc, bound by "
                           "cylon_tpu_torch.kernels", "B"),
    "platform": ("picks Pallas or XLA:CPU paths under JAX tracing, which "
                 "the port does not have", "Still to port"),
    "column.Column.tree_flatten": _PYTREE,
    "column.Column.tree_unflatten": _PYTREE,
    "table.Table.tree_flatten": _PYTREE,
    "table.Table.tree_unflatten": _PYTREE,
    "config.SortOptions.ascending": (
        "a field nothing in the JAX package reads; the direction is "
        "dist_sort's argument", "A13"),
    "config.SortOptions.__init__(ascending=)": (
        "the field above", "A13"),
    "context.TPUConfig": ("DistConfig stands for it: a torch.distributed "
                          "process group", "A13"),
    "TPUConfig": ("the same, re-exported", "A13"),
    "context.CylonEnv.mesh": _MESH,
    "context.CylonEnv.world_axes": _MESH,
    "context.CylonEnv.row_spec": _MESH,
    "context.CylonEnv.row_sharding": _MESH,
    "context.CylonEnv.replicated_sharding": _MESH,
    "context.CylonEnv.platform": ("the JAX platform's name; the port's "
                                  "device is CylonEnv.device", "A13"),
    "ops.join": ("the name is the module's in the port, as "
                 "test_torch_hash_join imports it; the function is "
                 "ops.join.join", "A13"),
    "ops.kernels.f64_bits": ("float bits by hand around the TPU's missing "
                             "f64 bitcast; the port views the bits", "A13"),
    "ops.kernels.float_bits": ("the same; the port views the bits",
                               "A13"),
    "ops.kernels.split_words": ("a bytes column's words are split by "
                                "kernels.pack_order_keys", "A13"),
    "ops.kernels.inverse_perm": ("the port inverts a permutation inline, "
                                 "with one scatter where it needs it",
                                 "A13"),
    "ops.kernels.group_sort(stable=)": _ORDER_KEYS,
    "ops.kernels.sort_perm(keys=)": _ORDER_KEYS,
    "ops.kernels.sort_perm(ascending=)": _ORDER_KEYS,
    "ops.kernels.sort_perm(stable=)": _ORDER_KEYS,
    "ops.selection.columns_to_payloads": _PAYLOADS,
    "ops.selection.payload_words": _PAYLOADS,
    "ops.selection.payloads_to_columns": _PAYLOADS,
    "ops.selection.use_gather_path": _PAYLOADS,
    "parallel.collectives.all_reduce(axis_name=)": _MESH,
    "parallel.collectives.rank(axis_name=)": _MESH,
    "parallel.collectives.world(axis_name=)": _MESH,
    "parallel.dist_row_mask": _SHARDED,
    "parallel.is_distributed": _SHARDED,
    "parallel.local_capacity": _SHARDED,
    "parallel.dtable.dist_row_mask": _SHARDED,
    "parallel.dtable.is_distributed": _SHARDED,
    "parallel.dtable.local_capacity": _SHARDED,
    "parallel.dtable.device_put_table": _SHARDED,
    "parallel.dtable.host_counts": _SHARDED,
    "parallel.dtable.num_shards": _SHARDED,
    "parallel.shuffle.exchange_arrays(axis_name=)": _MESH,
    "parallel.shuffle.exchange_arrays(bucket_cap=)": _PADDED,
    "parallel.shuffle.exchange_arrays(mid_cap=)": _PADDED,
    "parallel.shuffle.shuffle_local(axis_name=)": _MESH,
    "parallel.shuffle.shuffle_local(bucket_cap=)": _PADDED,
    "parallel.shuffle.shuffle_local(mid_cap=)": _PADDED,
    "parallel.shuffle.wire_rows_per_shard": _PADDED,
    "plan.adaptive_enabled": _SWITCHES,
    "plan.tight_enabled": _SWITCHES,
    "plan.current_row_hint": _ROW_HINT,
    "plan.row_hint": _ROW_HINT,
    "resilience.accounting_enabled": (
        "CYLON_TPU_ROW_ACCOUNTING is not read: the row check reads no "
        "device and always runs", "A7.1"),
    "telemetry.ICI_LINK_BYTES_PER_SEC": (
        "the TPU's interconnect rate; the port prices NVLink "
        "(NVLINK_BYTES_PER_SEC)", "A13"),
    "telemetry.export.ICI_LINK_BYTES_PER_SEC": (
        "the same, where it is defined", "A13"),
    "telemetry.memory.accumulate_array_bytes": (
        "walks JAX arrays' shards; the port walks live tensors "
        "(telemetry.memory)", "A13"),
}


def _params(fn) -> "list | None":
    """A callable's parameter names but ``self`` / ``cls`` and the
    ``*args`` / ``**kwargs`` catch-alls; None without a signature."""
    try:
        sig = inspect.signature(fn)
    except (TypeError, ValueError):
        return None
    return [p.name for p in sig.parameters.values()
            if p.kind not in (p.VAR_POSITIONAL, p.VAR_KEYWORD)
            and p.name not in ("self", "cls")]


def _check_params(path, theirs, ours, gaps):
    want = _params(theirs)
    if want is None:
        return
    have = _params(ours)
    if have is None:
        gaps.append(f"{path}()")
        return
    gaps.extend(f"{path}({n}=)" for n in want if n not in have)


def _members(cls) -> dict:
    """A JAX class's public members: methods, properties, class
    attributes, dataclass fields and enum members, its own and those of
    its ``cylon_tpu`` bases, with ``__init__`` and ``__call__``."""
    out = {}
    if issubclass(cls, enum.Enum):
        out.update((n, getattr(cls, n)) for n in cls.__members__)
    for klass in cls.__mro__:
        if not klass.__module__.startswith("cylon_tpu"):
            continue
        for n, v in vars(klass).items():
            if not n.startswith("_") or n in ("__init__", "__call__"):
                out.setdefault(n, v)
        for n in getattr(klass, "__dataclass_fields__", {}):
            if not n.startswith("_"):
                out.setdefault(n, None)
    return out


def _has_member(cls, name) -> bool:
    return hasattr(cls, name) or name in getattr(
        cls, "__dataclass_fields__", {})


def _unwrap(v):
    return v.__func__ if isinstance(v, (staticmethod, classmethod)) else v


def _check_class(path, theirs, ours, gaps):
    if not inspect.isclass(ours):
        gaps.append(path)
        return
    for n, v in _members(theirs).items():
        if not _has_member(ours, n):
            gaps.append(f"{path}.{n}")
            continue
        v = _unwrap(v)
        if inspect.isfunction(v):
            mine = _unwrap(inspect.getattr_static(ours, n))
            if callable(mine):
                _check_params(f"{path}.{n}", v, mine, gaps)


def _public_names(mod) -> set:
    """What a JAX module offers: its ``__all__`` and the functions and
    classes it defines."""
    names = set(getattr(mod, "__all__", ()))
    names.update(n for n, v in vars(mod).items()
                 if not n.startswith("_")
                 and (inspect.isfunction(v) or inspect.isclass(v))
                 and v.__module__ == mod.__name__)
    return names


def surface_gaps(rel: str) -> list:
    """The paths of module ``rel``'s public surface that the port does
    not have."""
    suffix = f".{rel}" if rel else ""
    theirs = importlib.import_module(f"cylon_tpu{suffix}")
    try:
        ours = importlib.import_module(f"cylon_tpu_torch{suffix}")
    except ModuleNotFoundError:
        return [rel]
    gaps: list = []
    for n in sorted(_public_names(theirs)):
        path = f"{rel}.{n}" if rel else n
        if not hasattr(ours, n):
            gaps.append(path)
            continue
        v, mine = getattr(theirs, n), getattr(ours, n)
        if getattr(v, "__module__", None) != theirs.__name__ or \
                getattr(v, "__name__", n) != n:
            # a re-export or an alias: of its kind here, its surface
            # checked at its home
            if (inspect.isclass(v) and not inspect.isclass(mine)) or \
                    (inspect.isfunction(v) and not callable(mine)):
                gaps.append(path)
            continue
        if inspect.isclass(v):
            _check_class(path, v, mine, gaps)
        elif inspect.isfunction(v):
            if callable(mine):
                _check_params(path, v, mine, gaps)
            else:
                gaps.append(path)
    return gaps


@pytest.mark.parametrize("rel", MODULES)
def test_the_port_has_the_jax_modules_surface(rel):
    assert [g for g in surface_gaps(rel) if g not in DELIBERATE] == []


def test_every_deliberate_entry_is_still_a_gap():
    gaps = {g for rel in MODULES for g in surface_gaps(rel)}
    assert sorted(set(DELIBERATE) - gaps) == []
    for path, (reason, item) in DELIBERATE.items():
        assert reason and item, path


def test_the_module_list_is_the_jax_packages():
    import cylon_tpu

    found = [""]
    for info in pkgutil.walk_packages(cylon_tpu.__path__, "cylon_tpu."):
        try:
            importlib.import_module(info.name)
        except Exception:   # noqa: BLE001 -- a file that is no module
            continue
        found.append(info.name[len("cylon_tpu."):])
    assert sorted(found) == sorted(MODULES)
