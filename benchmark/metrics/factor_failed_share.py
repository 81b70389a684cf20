"""factor_failed_share: the share of the window's dense factorizations
whose LM step came out not finite, dense.factor_failed / dense.factor
(utils/dispatch; the flag rides on the LM step's one host read). A
Cholesky factorization that fails, the damped reduced system not
positive definite in float32, gives a NaN step, which LM rejects: the
iteration's work is spent and lambda grows. It may read 0.

Source: the program's counters."""


def read(ctx):
    factors = ctx.counts.get("dense.factor", 0)
    if not factors:
        return None
    return ctx.counts.get("dense.factor_failed", 0) / factors
