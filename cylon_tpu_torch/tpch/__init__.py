"""TPC-H: a dbgen-style generator and the 22 queries.

Port of ``cylon_tpu/tpch/__init__.py``. BASELINE.json's configuration 5
("TPC-H SF100 Q3/Q5 multi-way join + groupby pipeline") names TPC-H as a
headline workload; the reference ships only synthetic join benchmarks,
so this is the benchmark-parity layer: a deterministic generator
(:mod:`.dbgen`, numpy) and the queries (:mod:`.queries`) over the
:class:`cylon_tpu_torch.DataFrame` surface, run locally or over a
world's ranks (``env=``)::

    from cylon_tpu_torch import tpch
    data = tpch.generate(sf=1.0, seed=0)     # {table: {column: array}}
    frames = tpch.ingest(data)               # on CUDA
    tpch.q3(frames).to_pandas()
    tpch.compiled("q5")(frames)              # one CUDA graph a query
"""

from cylon_tpu_torch import plan
from cylon_tpu_torch.tpch import queries as _q
from cylon_tpu_torch.tpch.dbgen import date_int, generate, generate_pandas
from cylon_tpu_torch.tpch.queries import (q1, q2, q3, q4, q5, q6, q7, q8,
                                          q9, q10, q11, q12, q13, q14, q15,
                                          q16, q17, q18, q19, q20, q21, q22)


def ingest(data, device=None) -> dict:
    """A raw generator mapping -> DataFrames on ``device`` (``None``:
    CUDA) under the TPC-H string storage (comment columns as device
    bytes, every other string column as dictionary codes); frames pass
    through as they are."""
    return {k: _q._df(v, device) for k, v in data.items()}


#: the queries that still read a device value on the host inside a
#: capture, each with the file:line of its read. Empty: all 22 queries
#: run in capture mode without a host read, locally and at a world of
#: one (``tests/test_torch_capture.py`` holds this set to its lint). A
#: first entry also brings the eager route that ``compiled`` would take
#: for it
EAGER_QUERIES: dict = {}


def compiled(q) -> plan.CompiledQuery:
    """The query ``q`` (a name such as ``"q3"``, or the function) through
    the process-wide :class:`~cylon_tpu_torch.plan.CompiledQuery`
    (:func:`~cylon_tpu_torch.plan.shared_compiled`), with the eager
    query's signature. On CUDA tensors at a world of one each call after
    the first replays one CUDA graph: one launch, one fetch of the
    overflow flags, row counts and scalars, the results copied out of
    the graph's pool. Scalar queries (q6, q14, q17, q19) return a 0-d
    tensor on the device instead of a float. A raw mapping goes to the
    query as it is, which prunes it to the manifest's columns before it
    builds them (on the env's device when ``env=`` is given); host
    arrays, CPU tensors and worlds of more than one rank take the eager
    route."""
    return plan.shared_compiled(getattr(_q, q) if isinstance(q, str) else q)

__all__ = ["EAGER_QUERIES", "compiled", "date_int", "generate",
           "generate_pandas",
           "ingest"] + [f"q{i}" for i in range(1, 23)]
