"""programs_s: host seconds of the full-range factor and solve schedules
and device programs (ops/schedule.py, ops/planned_backend.py), by the
host clock around factor_program() and solve_program() in set-up."""


def read(run):
    return run.stages.get("programs")
