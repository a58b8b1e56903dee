"""Error model: the reference's ``cylon::Status`` codes as exceptions.

Port of the part of ``cylon_tpu/errors.py`` that the port raises, and
every member of its :class:`Code`. The numbers are the reference's
(``cpp/src/cylon/code.hpp:20-40``), so callers can switch on ``exc.code``
and the serve and fleet layers and the C ABI read the same numbers in
both packages; 14-17 and 8 are the JAX package's extensions for the
resilience, deadline and serving layers (gRPC's UNAVAILABLE / DATA_LOSS /
RESOURCE_EXHAUSTED numbers where the reference leaves them free).
"""

import enum


class Code(enum.IntEnum):
    OK = 0
    OutOfMemory = 1
    KeyError = 2
    TypeError = 3
    Invalid = 4
    IOError = 5
    CapacityError = 6
    IndexError = 7
    ResourceExhausted = 8
    UnknownError = 9
    NotImplemented = 10
    SerializationError = 11
    GpuMemoryError = 12
    RError = 13
    Unavailable = 14
    DataLoss = 15
    DeadlineExceeded = 16
    FailedPrecondition = 17
    CodeGenError = 40
    ExpressionValidationError = 41
    ExecutionError = 42
    AlreadyExists = 45


class CylonError(Exception):
    """Base class; carries a :class:`Code` like ``cylon::Status``."""

    code: Code = Code.UnknownError

    def __init__(self, msg: str = "", code: "Code | None" = None):
        super().__init__(msg)
        if code is not None:
            self.code = code


class InvalidArgument(CylonError):
    code = Code.Invalid


class KeyError_(CylonError):
    code = Code.KeyError


class TypeError_(CylonError):
    code = Code.TypeError


class IndexError_(CylonError):
    code = Code.IndexError


class IOError_(CylonError):
    code = Code.IOError


class NotImplemented_(CylonError, NotImplementedError):
    """A feature that a later slice of the port brings; the message names
    it."""

    code = Code.NotImplemented


class DeviceUnavailable(CylonError):
    """The default device is CUDA and no CUDA device is present."""

    code = Code.Unavailable


class OutOfCapacity(CylonError):
    """A capacity-bounded operator produced more rows than its static
    bound (``nrows == capacity + 1`` marks it); raised by the host-side
    row-count check."""

    code = Code.CapacityError


class TransientError(CylonError):
    """A failure that retrying is expected to fix: worker preemption,
    flaky IO, an injected fault. :func:`cylon_tpu_torch.resilience.is_retryable`
    keys on this class (and on ``Code.Unavailable`` generally)."""

    code = Code.Unavailable


class DataLossError(CylonError):
    """A row-accounting invariant failed: a multi-pass pipeline or an
    exchange saw a different number of rows going in than coming out.
    Never retryable: the data is already gone."""

    code = Code.DataLoss


class DeadlineExceeded(CylonError):
    """A named blocking section (:mod:`cylon_tpu_torch.watchdog`) stalled
    past its deadline. The watchdog dumps all-thread stacks to stderr
    before this is raised. ``retryable`` is classified per section
    (:data:`cylon_tpu_torch.watchdog.SECTIONS`): bootstrap and spill-IO
    deadlines may heal on retry, a deadline mid-collective never does."""

    code = Code.DeadlineExceeded

    def __init__(self, msg: str = "", *, section: "str | None" = None,
                 elapsed: "float | None" = None, retryable: bool = False):
        super().__init__(msg)
        self.section = section
        self.elapsed = elapsed
        self.retryable = bool(retryable)


class FailedPrecondition(CylonError):
    """The system is not in a state the operation needs (the serving
    layer's draining engine, a closed session). Not retryable as is."""

    code = Code.FailedPrecondition


class ResourceExhausted(CylonError):
    """A bounded resource (an admission queue, a memory budget) refused
    the request. Not retried by the engine: the retry decision is the
    client's."""

    code = Code.ResourceExhausted
