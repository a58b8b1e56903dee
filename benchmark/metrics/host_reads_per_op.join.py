"""The program's own count of its blocking transfers between host and
device (``host.reads``, every site) over the window, per operation; each
runs under a ``host_read.<site>`` span."""

from benchmark.harness import program


def read(ctx):
    return program.counter_per_op(ctx, "host.reads")
