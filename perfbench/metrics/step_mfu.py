"""step_mfu: the whole step's operations (factor and solve, from the
skeleton, perfbench/work.py) over the measured window's time per step
times the card's peak FLOP/s, in %. It bounds the kernels' rooflines: a
kernel taken off the path leaves its roofline silent, this share not."""


def read(run):
    if run.peak is None or not run.steps:
        return None
    flops = sum(w.flops for w in run.work.values())
    return 100.0 * flops / (run.wall_s / run.steps * run.peak[0])
