"""Host IO: CSV / Parquet / JSON ingest and egress.

Port of ``cylon_tpu/io/__init__.py`` with its ``arrow`` engine (parity:
``cpp/src/cylon/io/`` and the threaded multi-file readers of
``table.cpp:788-795`` / ``:1121-1127``). pyarrow parses, as in the
reference; the columns then go to the device as a padded table.

Distributed reads follow the port's SPMD model: ``read_csv(env=...)``
parses the whole file on every rank, which keeps its own block;
:func:`read_csv_sharded` is the scale-out path, rank ``r`` parsing
``paths[r]`` only. The JAX package's C++ ``native`` engine waits for the
port's host library (ROADMAP A9): ``engine="native"`` raises
:class:`NotImplemented_` and ``"auto"`` takes ``arrow``. Every file read
and chunk reader's open hits the ``io_read`` injection point and runs
under :func:`cylon_tpu_torch.resilience.retrying` (a transient failure
is retried with backoff), as in ``cylon_tpu/io/__init__.py:96-101``,
``:432-438``, ``:483-487`` and ``:610-613``.
"""

import pickle
from concurrent.futures import ThreadPoolExecutor
from typing import Sequence

import numpy as np
import torch

from cylon_tpu_torch import device as _device
from cylon_tpu_torch import resilience
from cylon_tpu_torch.config import (CSVReadOptions, CSVWriteOptions,
                                    ParquetOptions)
from cylon_tpu_torch.errors import (InvalidArgument, IOError_,
                                    NotImplemented_)
from cylon_tpu_torch.table import Table
from cylon_tpu_torch.utils import pow2_bucket

__all__ = ["read_csv", "read_csv_chunks", "read_csv_sharded", "read_json",
           "read_parquet", "read_parquet_chunks", "write_csv",
           "write_csv_sharded", "write_parquet"]


def _check_engine(engine: str) -> None:
    if engine == "native":
        raise NotImplemented_(
            "the native csv engine comes with the port's host library "
            "(ROADMAP A9); use engine='arrow'")
    if engine not in ("auto", "arrow"):
        raise InvalidArgument(f"unknown csv engine {engine!r}")


def _column_types_arrow(column_types):
    """{name: "int64" | "float64" | "str" | numpy dtype-like} -> pyarrow
    types."""
    import pyarrow as pa

    out = {}
    for name, t in (column_types or {}).items():
        out[name] = pa.string() if t in ("str", "string", str) \
            else pa.from_numpy_dtype(np.dtype(t))
    return out or None


def _arrow_csv_opts(options: CSVReadOptions):
    """(ReadOptions, ParseOptions, ConvertOptions) for pyarrow.csv."""
    import pyarrow.csv as pacsv

    read_opts = pacsv.ReadOptions(
        use_threads=options.use_threads,
        block_size=options.block_size,
        skip_rows=options.skip_rows,
        column_names=(list(options.column_names)
                      if options.column_names else None),
        autogenerate_column_names=options.auto_generate_column_names)
    parse_opts = pacsv.ParseOptions(
        delimiter=options.delimiter,
        ignore_empty_lines=options.ignore_emptylines,
        quote_char=options.quote_char if options.use_quoting else False,
        double_quote=options.double_quote,
        escape_char=(options.escaping_character if options.use_escaping
                     else False),
        newlines_in_values=options.has_newlines_in_values)
    convert_kw = dict(
        include_columns=list(options.use_cols) if options.use_cols
        else None,
        include_missing_columns=options.include_missing_columns,
        strings_can_be_null=options.strings_can_be_null,
        column_types=_column_types_arrow(options.column_types))
    # pyarrow reads an empty list as "nothing is null / true / false":
    # override its defaults only where the caller set spellings
    if options.na_values is not None:
        convert_kw["null_values"] = list(options.na_values)
    if options.true_values is not None:
        convert_kw["true_values"] = list(options.true_values)
    if options.false_values is not None:
        convert_kw["false_values"] = list(options.false_values)
    return read_opts, parse_opts, pacsv.ConvertOptions(**convert_kw)


def _arrow_csv_read(path, options: CSVReadOptions):
    import pyarrow.csv as pacsv

    read_opts, parse_opts, convert = _arrow_csv_opts(options)

    def _read():
        resilience.inject("io_read", str(path))
        return pacsv.read_csv(path, read_options=read_opts,
                              parse_options=parse_opts,
                              convert_options=convert)

    return resilience.retrying(_read, label=f"read_csv {path}")


def _read_all(paths: list, read_one, concurrent: bool) -> list:
    """Each path read on its own thread (parity: a std::thread per
    file, ``table.cpp:788-795``), in path order."""
    if len(paths) == 1 or not concurrent:
        return [read_one(p) for p in paths]
    with ThreadPoolExecutor(max_workers=min(8, len(paths))) as ex:
        return list(ex.map(read_one, paths))


def _frame(table: Table, env, slice_: bool = False):
    """A local frame over ``table``, or this rank's block of it when
    ``env`` is given (``slice_`` alone: a world of one)."""
    from cylon_tpu_torch.frame import DataFrame

    if env is None and slice_:
        from cylon_tpu_torch.context import CylonEnv

        env = CylonEnv()
    return DataFrame(table, env=env)


def read_csv(paths, options: "CSVReadOptions | None" = None, env=None,
             capacity: "int | None" = None, engine: str = "auto",
             device=None):
    """Read one or many CSVs (parity: ``FromCSV``, table.cpp:788: many
    paths on threads, concatenated in path order) into a DataFrame on
    ``device`` (None: CUDA). With ``env`` every rank parses the files and
    keeps its own block: a distributed frame."""
    _check_engine(engine)
    dev = _device.resolve(device)
    options = options or CSVReadOptions()
    path_list = [paths] if isinstance(paths, (str, bytes)) else list(paths)
    try:
        atables = _read_all(path_list,
                            lambda p: _arrow_csv_read(p, options),
                            options.concurrent_file_reads)
    except Exception as e:   # pyarrow raises its own hierarchy
        raise IOError_(f"csv read failed: {e}") from e
    import pyarrow as pa

    at = pa.concat_tables(atables) if len(atables) > 1 else atables[0]
    return _frame(Table.from_arrow(at, capacity, dev), env, options.slice)


def _exchange_meta(env, local_meta: dict, device) -> list:
    """Every rank's small host metadata, in rank order (port of
    ``cylon_tpu/io/__init__.py:209``): the pickled bytes ride the
    communicator, one all-gather of their lengths and one of the bytes
    padded to the longest. A world of one returns its own."""
    if env.world_size == 1:
        return [local_meta]
    blob = np.frombuffer(pickle.dumps(local_meta), np.uint8)
    sizes = env.comm.all_gather(torch.tensor(
        [blob.size], dtype=torch.int64, device=device)).reshape(-1).tolist()
    padded = np.zeros(max(sizes), np.uint8)
    padded[:blob.size] = blob
    got = env.comm.all_gather(_device.from_host(padded, device)).cpu() \
        .numpy().reshape(env.world_size, -1)
    return [pickle.loads(got[r, :sizes[r]].tobytes())
            for r in range(env.world_size)]


def read_csv_sharded(paths: Sequence[str], env,
                     options: "CSVReadOptions | None" = None,
                     local_capacity: "int | None" = None, device=None):
    """Scale-out ingest, one file a rank (parity: the reference's per-rank
    reads, ``table.cpp:788-795``): rank ``r`` parses ``paths[r]`` and
    places its rows on its own device; no rank holds the whole table.
    ``len(paths)`` must be the world size.

    The ranks exchange their host metadata (row counts, column names and
    types), then bring their shards to one layout
    (:func:`~cylon_tpu_torch.parallel.dtable.world_layout`: string
    dictionaries merged, validity added where any rank has nulls) and
    one capacity (``local_capacity``, or the power-of-two bucket of the
    largest shard). Returns a distributed DataFrame. A collective."""
    from cylon_tpu_torch.frame import DataFrame
    from cylon_tpu_torch.parallel.dtable import world_layout

    dev = _device.resolve(device)
    options = options or CSVReadOptions()
    paths = list(paths)
    w = env.world_size
    if len(paths) != w:
        raise InvalidArgument(
            f"read_csv_sharded needs exactly one path per worker ({w}), "
            f"got {len(paths)}")
    try:
        at = _arrow_csv_read(paths[env.rank], options)
    except Exception as e:
        raise IOError_(f"csv read failed: {e}") from e
    if options.use_cols:
        at = at.select(list(options.use_cols))
    t = Table.from_arrow(at, None, dev)
    all_meta = _exchange_meta(env, {
        "count": at.num_rows, "names": t.column_names,
        "types": [repr(c.dtype) for c in t.columns.values()]}, dev)
    names, types = all_meta[0]["names"], all_meta[0]["types"]
    for r, m in enumerate(all_meta):
        # names and order must agree, or the ranks would run different
        # programs
        if m["names"] != names:
            raise InvalidArgument(
                f"shard files disagree on columns: {paths[0]} has "
                f"{names}, {paths[r]} has {m['names']}")
        for n, a, b in zip(names, types, m["types"]):
            if a != b and not (a.startswith("string")
                               and b.startswith("string")):
                raise InvalidArgument(
                    f"column {n!r} parsed with different dtypes across "
                    f"shard files: {sorted({a, b})}; pass explicit dtypes")
    most = max(m["count"] for m in all_meta)
    if local_capacity is not None and local_capacity < most:
        raise InvalidArgument(
            f"local_capacity {local_capacity} is below the largest shard "
            f"file's row count {most}")
    t = world_layout(env, t).with_capacity(local_capacity
                                           or pow2_bucket(most))
    return DataFrame._wrap(t, env=env)


def read_csv_chunks(path, chunk_rows: int,
                    options: "CSVReadOptions | None" = None, device=None):
    """Out-of-core CSV source: ``Table`` chunks of capacity exactly
    ``chunk_rows`` from pyarrow's incremental reader, never the whole
    file on the host (the ingest end of the streaming graph,
    ``ops/dis_join_op.cpp:21-72``). Feed them to
    :class:`cylon_tpu_torch.ops_graph.DisJoinOp` and its kin. String
    columns take a dictionary a chunk; joins and shuffles unify them by
    value. Arguments and the file are checked at the call."""
    import pyarrow.csv as pacsv

    if chunk_rows <= 0:
        raise IOError_(f"chunk_rows must be positive, got {chunk_rows}")
    dev = _device.resolve(device)
    options = options or CSVReadOptions()
    read_opts, parse_opts, convert = _arrow_csv_opts(options)

    def _open():
        resilience.inject("io_read", str(path))
        return pacsv.open_csv(path, read_options=read_opts,
                              parse_options=parse_opts,
                              convert_options=convert)

    try:
        reader = resilience.retrying(_open, label=f"read_csv_chunks {path}")
    except Exception as e:
        raise IOError_(f"csv chunk read failed: {e}") from e
    return _csv_chunk_iter(reader, chunk_rows, dev)


def _csv_chunk_iter(reader, chunk_rows: int, dev):
    import pyarrow as pa

    pending, npend = [], 0   # record batches, together < chunk_rows + block
    try:
        with reader:
            for batch in reader:
                if batch.num_rows == 0:
                    continue
                pending.append(batch)
                npend += batch.num_rows
                while npend >= chunk_rows:
                    tbl = pa.Table.from_batches(pending)
                    yield Table.from_arrow(tbl.slice(0, chunk_rows),
                                           chunk_rows, dev)
                    rest = tbl.slice(chunk_rows)
                    pending = rest.to_batches() if rest.num_rows else []
                    npend = rest.num_rows
    except Exception as e:
        raise IOError_(f"csv chunk read failed: {e}") from e
    if npend:
        yield Table.from_arrow(pa.Table.from_batches(pending), chunk_rows,
                               dev)


def read_parquet_chunks(path, chunk_rows: int,
                        columns: "Sequence[str] | None" = None, device=None):
    """Out-of-core Parquet source: ``chunk_rows``-capacity chunks from
    pyarrow's batch iterator (the Parquet twin of
    :func:`read_csv_chunks`)."""
    import pyarrow.parquet as pq

    if chunk_rows <= 0:
        raise IOError_(f"chunk_rows must be positive, got {chunk_rows}")
    dev = _device.resolve(device)

    def _open():
        resilience.inject("io_read", str(path))
        return pq.ParquetFile(path)  # eager: a missing file raises here

    try:
        pf = resilience.retrying(_open,
                                 label=f"read_parquet_chunks {path}")
    except Exception as e:
        raise IOError_(f"parquet chunk read failed: {e}") from e
    return _parquet_chunk_iter(pf, chunk_rows, columns, dev)


def _parquet_chunk_iter(pf, chunk_rows: int, columns, dev):
    import pyarrow as pa

    try:
        for batch in pf.iter_batches(batch_size=chunk_rows,
                                     columns=columns):
            if batch.num_rows:
                yield Table.from_arrow(pa.Table.from_batches([batch]),
                                       chunk_rows, dev)
    except Exception as e:
        raise IOError_(f"parquet chunk read failed: {e}") from e


def write_csv(df, path, options: "CSVWriteOptions | None" = None):
    """Parity: ``WriteCSV`` (table.cpp:243). A distributed frame is
    gathered first: a collective, and every rank writes ``path``."""
    options = options or CSVWriteOptions()
    pdf = df.to_pandas() if hasattr(df, "to_pandas") else df
    pdf.to_csv(path, sep=options.delimiter, index=False,
               header=options.include_header)


def write_csv_sharded(df, paths: Sequence[str], env,
                      options: "CSVWriteOptions | None" = None) -> list:
    """Scale-out egress, one file a rank: rank ``r`` writes its shard's
    rows to ``paths[r]`` and no rank assembles the table (the mirror of
    :func:`read_csv_sharded`; parity: the reference's per-rank
    ``WriteCSV``). ``df`` is a DataFrame (a local one is taken as the
    whole table on every rank and each rank writes its block) or this
    rank's shard as a Table. Returns the paths this rank wrote. A
    collective: the shards' counts are checked for overflow on every
    rank."""
    from cylon_tpu_torch.parallel.dtable import shard_counts

    options = options or CSVWriteOptions()
    t = df._sharded(env) if hasattr(df, "_sharded") else df
    paths = list(paths)
    if len(paths) != env.world_size:
        raise InvalidArgument(
            f"write_csv_sharded needs exactly one path per worker "
            f"({env.world_size}), got {len(paths)}")
    shard_counts(env, t)   # OutOfCapacity on every rank if any overflowed
    mine = paths[env.rank]
    t.to_pandas().to_csv(mine, sep=options.delimiter, index=False,
                         header=options.include_header)
    return [mine]


def read_parquet(paths, env=None, capacity: "int | None" = None,
                 columns: "Sequence[str] | None" = None,
                 options: "ParquetOptions | None" = None,
                 string_storage="dict", device=None):
    """Parity: ``FromParquet`` (table.cpp:1121); ``options`` is the
    ``ParquetOptions`` mirror of ``io/parquet_config.hpp``. With ``env``
    every rank keeps its own block."""
    import pyarrow as pa
    import pyarrow.parquet as pq

    dev = _device.resolve(device)
    options = options or ParquetOptions()
    if columns is None:
        columns = options.use_cols
    path_list = [paths] if isinstance(paths, (str, bytes)) else list(paths)
    def _read_one(p):
        def _read():
            resilience.inject("io_read", str(p))
            return pq.read_table(p, columns=columns)

        return resilience.retrying(_read, label=f"read_parquet {p}")

    try:
        atables = _read_all(path_list, _read_one,
                            options.concurrent_file_reads)
    except Exception as e:
        raise IOError_(f"parquet read failed: {e}") from e
    at = pa.concat_tables(atables) if len(atables) > 1 else atables[0]
    return _frame(Table.from_arrow(at, capacity, dev, string_storage), env)


def write_parquet(df, path, options: "ParquetOptions | None" = None):
    """Parity: ``WriteParquet`` (table.cpp:1148) with the
    ``ParquetOptions`` writer properties (compression, row-group size,
    dictionary encoding, column subset). A distributed frame is gathered
    first: a collective."""
    import pyarrow.parquet as pq

    options = options or ParquetOptions()
    at = df.to_arrow() if hasattr(df, "to_arrow") else df
    if options.write_cols is not None:
        at = at.select(list(options.write_cols))
    comp = options.compression
    pq.write_table(at, path,
                   compression=None if comp in ("none", None) else comp,
                   row_group_size=options.row_group_size,
                   use_dictionary=options.use_dictionary)


def read_json(path, env=None, capacity: "int | None" = None, device=None):
    """JSON-lines ingest (parity: pycylon's json read helpers)."""
    import pyarrow.json as pajson

    dev = _device.resolve(device)
    try:
        at = pajson.read_json(path)
    except Exception as e:
        raise IOError_(f"json read failed: {e}") from e
    return _frame(Table.from_arrow(at, capacity, dev), env)
