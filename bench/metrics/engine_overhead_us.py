"""Engine layer: host microseconds per request of ``ReservoirEngine.submit``
and the copy of its predictions to the host, less the device time of the
operations it ran (profiler); the mean over the window."""


def read(run):
    w = run.window
    if run.trace is None or not w.done:
        return None
    host = sum(t1 - t0 for name, t0, t1 in w.spans
               if name in ("submit", "copy"))
    device = sum(e - s for _n, s, e in run.device_ops())
    return (host - device) / 1e3 / len(w.done)
