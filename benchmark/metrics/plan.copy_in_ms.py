"""Mean device ms of the program's ``plan.copy_in`` span (a replay's
inputs copied into its graph's buffers) per span."""

from benchmark.harness import program


def read(ctx):
    return program.device_ms_per_span(ctx, "plan.copy_in")
