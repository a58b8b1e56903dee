"""Device ms of the program's ``join.indices`` span (the local join's
index plans: the group sort, the scans, the packed gather; on the hash
route the build, the probe and the emit), per traced operation."""

from benchmark.harness import program


def read(ctx):
    return program.device_ms_per_op(ctx, "join.indices")
