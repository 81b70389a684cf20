"""peak_mem_gib: the most device memory the port held at once during the
window, GiB (torch.cuda.max_memory_allocated after a reset right before
the window; the window's answers are moved to the host as they come).

Source: the caching allocator's counter."""


def read(ctx):
    if not ctx.peak_bytes:
        return None
    return ctx.peak_bytes / 2**30
