"""analysis_s: host seconds of the port's analysis, create_solver
(solver.py, sparse_structure.py, elimination_tree.py, ordering.py,
native.py), by the host clock around the call in set-up."""


def read(run):
    return run.stages.get("analysis")
