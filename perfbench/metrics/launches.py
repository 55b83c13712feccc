"""launches: __global__ launches of the port's kernels per step
(ops/kernels.py COUNTS, grid_launches), over the measured window."""


def read(run):
    return run.launches / run.steps if run.steps else None
