"""The 95th percentile of the walls of all operations of the window, each
from its issue to its complete result, in ms."""

from benchmark.harness import readers


def read(ctx):
    return 1e3 * readers.p95(readers.walls(ctx))
