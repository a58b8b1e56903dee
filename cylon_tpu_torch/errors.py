"""Error model: the reference's ``cylon::Status`` codes as exceptions.

Port of the part of ``cylon_tpu/errors.py`` that the port raises.
The :class:`Code` numbers are the reference's
(``cpp/src/cylon/code.hpp:20-40``), so callers can switch on ``exc.code``.
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
    UnknownError = 9
    NotImplemented = 10
    GpuMemoryError = 12
    Unavailable = 14


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
