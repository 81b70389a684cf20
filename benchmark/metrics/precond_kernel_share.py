"""precond_kernel_share: the share of the window's SCHUR_JACOBI builds
(counter "precond.build") that ran through the hand-written kernel of
csrc/schur_precond.cu, as the program counts them: launches of
sfm/ba/schur_precond.corr ("precond_kernel") over builds. 1 where every
build took the kernel.

Source: the program's counters, over the window. Nothing to read (None)
where no launch was counted: a program without the kernel, or a cell
whose builds take the plain path."""


def read(ctx):
    n = ctx.counts.get("precond.build", 0)
    launches = ctx.counts.get("precond_kernel", 0)
    if not n or not launches:
        return None
    return launches / n
