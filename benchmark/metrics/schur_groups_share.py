"""schur_groups_share: the share of the window's reduced-system products
S·v that ran through the grouped Schur kernels (one intrinsics group per
observation: csrc/schur_groups.cu via fused_matvec.pass1_groups), as the
program counts them: grouped pass-1 launches ("schur_pass1_groups") over
products ("schur_matvec"). 1 where every product took the grouped
kernels.

Source: the program's counters, over the window. Nothing to read (None)
where no grouped launch was counted: a program without the grouped
kernels, or a cell whose products take another path."""


def read(ctx):
    n = ctx.counts.get("schur_matvec", 0)
    launches = ctx.counts.get("schur_pass1_groups", 0)
    if not n or not launches:
        return None
    return launches / n
