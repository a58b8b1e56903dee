"""From the start of the process to the first timed operation: the CUDA
context, the kernel library (loaded, or built on a checkout's first run),
the inputs, the program's tables, the warm-up and any capture."""


def read(ctx):
    return ctx.setup_s
