"""schur_products_per_iter: reduced-system products S·v per LM iteration,
the port's own count (utils/dispatch "schur_matvec", counted on the
kernel path and the plain path alike), one per CG iteration: the
length of the linear solves.

Source: the program's counter, over the window's LM iterations."""


def read(ctx):
    n = ctx.counts.get("schur_matvec", 0)
    if not n or not ctx.iterations:
        return None
    return n / ctx.iterations
