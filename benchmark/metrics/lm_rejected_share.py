"""lm_rejected_share: the share of the window's LM steps that the port
rejected, lm.rejected / (lm.accepted + lm.rejected) (utils/dispatch,
counted where the host reads each step's verdict). With no jacobian or
preconditioner reuse a rejected step costs as much as an accepted one;
a change of the numbers that alters LM's path inside the fixed iteration
count shows here.

Source: the program's counters."""


def read(ctx):
    accepted = ctx.counts.get("lm.accepted", 0)
    rejected = ctx.counts.get("lm.rejected", 0)
    if not accepted + rejected:
        return None
    return rejected / (accepted + rejected)
