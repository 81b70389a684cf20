"""host_syncs_per_iter: the port's host reads of device values per LM
iteration: the sum of its "sync.<site>" counters (utils/dispatch
host_sync: the CG stopping rule, the LM step, the uploads of host
constants, and on the kernel path the per-solve index checks), each a
point where the host waits for the card.

Source: the program's counters, over the window's LM iterations."""
PREFIX = "sync."


def read(ctx):
    n = sum(v for k, v in ctx.counts.items() if k.startswith(PREFIX))
    if not n or not ctx.iterations:
        return None
    return n / ctx.iterations
