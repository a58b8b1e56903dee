"""``torch.cuda.max_memory_allocated()`` over the window (peak stats reset
once after set-up), in GB (1e9 bytes): the resident tables, a compiled
query's input buffers and results, and the working set. Blocks a capture
freed into its graph's pool are held but not allocated, so they do not
count (the result line's ``memory_peak_bytes`` is the reserved peak, which
holds them)."""


def read(ctx):
    return ctx.peak_bytes / 1e9
