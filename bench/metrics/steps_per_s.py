"""Input steps answered (padding excluded) over the whole window: from
its open to the last due request's answer on the host."""


def read(run):
    w = run.window
    return w.answered_steps / w.seconds if w.seconds > 0 else None
