"""Logging: glog-style levels driven by ``CYLON_LOG_LEVEL``.

Parity: the reference logs through glog everywhere (``table.hpp:18``)
with ``util/logging.{hpp,cpp}`` wrapping init, and PyCylon maps the
``CYLON_LOG_LEVEL`` env var to ``log_level()``/``disable_logging()``
(``python/pycylon/__init__.py:30-43``). Same contract here on the
stdlib ``logging`` module: glog severities 0..3 = INFO, WARNING, ERROR,
FATAL; anything above disables.
"""

import logging
import os

_LOGGER_NAME = "cylon_tpu_torch"

#: glog severity -> stdlib level (``python/pycylon/util/logging.pyx``).
_GLOG_LEVELS = {0: logging.INFO, 1: logging.WARNING,
                2: logging.ERROR, 3: logging.CRITICAL}

_initialized = False

#: (rank, world) of the live process, set by ``CylonEnv.__init__`` —
#: None until an env exists, so library users who never construct one
#: keep the bare format.
_WORLD: "tuple[int, int] | None" = None


def set_world(rank: int, world: int) -> None:
    """Record the process's (rank, world); every subsequent log record
    is prefixed ``rank/world`` — on a multihost fleet the interleaved
    stderr streams are unreadable without it (the reference's glog
    lines carry the MPI rank the same way)."""
    global _WORLD
    _WORLD = (int(rank), int(world))


class _RankFilter(logging.Filter):
    """Injects ``record.rankprefix`` (``"[r/w] "`` once a CylonEnv is
    live, ``""`` before) for the handler's format string. A filter
    (not str concat at call sites) so EVERY record through the handler
    gets it, including records from third-party code routed here."""

    def filter(self, record):
        record.rankprefix = (f"[{_WORLD[0]}/{_WORLD[1]}] "
                             if _WORLD is not None else "")
        return True


def get_logger() -> logging.Logger:
    return logging.getLogger(_LOGGER_NAME)


def init_logging() -> None:
    """Idempotent init (mirrors ``pycylon.__init__``): reads
    ``CYLON_LOG_LEVEL`` and attaches one stderr handler with a
    glog-flavoured format and the rank prefix, and stops propagation.
    The JAX package calls it at import; the port leaves its logger to
    the application's logging configuration until the application
    calls it."""
    global _initialized
    if _initialized:
        return
    _initialized = True
    logger = get_logger()
    if not logger.handlers:
        h = logging.StreamHandler()
        h.setFormatter(logging.Formatter(
            "%(levelname).1s %(asctime)s %(name)s] "
            "%(rankprefix)s%(message)s",
            datefmt="%H:%M:%S"))
        h.addFilter(_RankFilter())
        logger.addHandler(h)
    logger.propagate = False
    env = os.environ.get("CYLON_LOG_LEVEL")
    if env is None:
        logger.setLevel(logging.WARNING)
        return
    try:
        log_level(int(env))
    except ValueError:
        logger.setLevel(logging.WARNING)
        logger.warning("bad CYLON_LOG_LEVEL=%r (want 0..4)", env)


def log_level(glog_severity: int) -> None:
    """Set the minimum severity, glog numbering (0=INFO .. 3=FATAL)."""
    if glog_severity in _GLOG_LEVELS:
        get_logger().setLevel(_GLOG_LEVELS[glog_severity])
    else:
        disable_logging()


def disable_logging() -> None:
    get_logger().setLevel(logging.CRITICAL + 1)
