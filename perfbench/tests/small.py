"""The two configurations cut to sizes a CPU test run can hold, and a
helper to run a cell on them."""

import copy
import io
import time

from perfbench import harness


def config(name: str) -> dict:
    cfg = harness.load_json(f"{harness.HERE}/configs/{name}.json")
    cfg = copy.deepcopy(cfg)
    if cfg["generator"] == "bal":
        cfg["params"].update(n_cams=24, n_pts=300, n_obs=1580)
    else:
        cfg["params"].update(width=10, height=10)
        cfg["batch"] = 4
    return cfg


CELLS = {"bal-871.refactor": "bal-871",
         "grid-200-b8.refactor": "grid-200-b8"}


def run(workload: str, device="cpu", seed=20231117, **kw) -> dict:
    return harness.run_cell(workload, seed, 0.2, False,
                            time.perf_counter(), device=device,
                            cfg=config(CELLS[workload]), out=io.StringIO(),
                            **kw)
