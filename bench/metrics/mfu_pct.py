"""Model step: the operations of every answered step (2 nnz(W) + 2 R I +
2 R O) over the window, as a share of the peak of the configuration's
arithmetic."""

from bench.arith import mfu_pct


def read(run):
    w = run.window
    if w.seconds <= 0:
        return None
    return mfu_pct(w.answered_steps * run.step_ops(), w.seconds, run.arith)
