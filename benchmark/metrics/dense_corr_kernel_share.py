"""dense_corr_kernel_share: the share of the window's correction builds of
the dense Schur solver (counter "dense.corr") that ran through the
hand-written kernels of csrc/dense_corr.cu, as the program counts them:
launches of sfm/ba/dense_corr.corr ("dense_corr_kernel") over builds. 1
where every build took the kernels.

Source: the program's counters, over the window. Nothing to read (None)
where no launch was counted: a program without the kernels, or a cell
whose builds take the plain path."""


def read(ctx):
    n = ctx.counts.get("dense.corr", 0)
    launches = ctx.counts.get("dense_corr_kernel", 0)
    if not n or not launches:
        return None
    return launches / n
