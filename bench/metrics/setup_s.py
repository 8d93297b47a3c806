"""From the process's start to the first timed request: imports, the
CUDA context, the seed's weights, the port's compile of the matrix, the
engine, kernel builds or loads, and the warm-up."""


def read(run):
    return run.setup_s
