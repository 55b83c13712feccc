"""Runs a cell in sets of runs, as the bounds in BENCHMARK.json are set,
and reads the spreads of its end-to-end metrics.

  python3 perfbench/sets.py --workload bal-871.refactor \\
      --seeds 2147483701,3000000019,123456789,2718281828,1618033988,2999999999 \\
      --sets 2 --seconds 10 --traces 3141592653,2236067977 \\
      --out chiprun_out/sets_bal

First one short run that builds what a checkout's first run builds (its
set-up is not read), then each set runs every seed once, in order, each
run a process of its own (perfbench/run.py), then one --trace 1 run for
each of --traces. Each run's output goes to <out>_<set>_<seed>.log and
its result line, with set and seed, to <out>.jsonl (set 0: the traced
runs). Then, for each end-to-end metric, it prints each set's median and
spread (the distance between the first and third quartiles of
statistics.quantiles(n=4), over the median), the same without the run
farthest from the median, the spread of all the sets' runs together,
and the ratio of the second set's median to the first's.

  python3 perfbench/sets.py --read chiprun_out/sets_bal.jsonl

reads an earlier <out>.jsonl again.
"""

import argparse
import json
import os
import statistics
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


def one(workload: str, seed: int, seconds: float, trace: int,
        log: str) -> dict:
    with open(log, "w") as f:
        p = subprocess.run(
            [sys.executable, os.path.join(HERE, "run.py"), "--workload",
             workload, "--seed", str(seed), "--seconds", str(seconds),
             "--trace", str(trace)], cwd=ROOT, stdout=subprocess.PIPE,
            stderr=f, text=True)
        f.write(p.stdout)
    lines = p.stdout.strip().splitlines()
    return {"rc": p.returncode,
            "result": json.loads(lines[-1]) if p.returncode == 0 else None}


def spread(v: list) -> float:
    q = statistics.quantiles(v, n=4)
    return (q[2] - q[0]) / statistics.median(v)


def without_farthest(v: list) -> list:
    med = statistics.median(v)
    v = list(v)
    v.remove(max(v, key=lambda x: abs(x - med)))
    return v


def read(rows: list) -> None:
    runs = [r for r in rows if r["set"] > 0]
    print(f"runs {len(runs)}, rcs {sorted({r['rc'] for r in rows})}, all "
          f"correct {all(r['result'] and r['result']['correct'] for r in rows)}")
    sets = sorted({r["set"] for r in runs})
    names = sorted({m for r in runs if r["result"]
                    for m in r["result"]["metrics"]})
    for m in names:
        by = {s: [r["result"]["metrics"][m]["value"] for r in runs
                  if r["set"] == s and r["result"]] for s in sets}
        parts = [f"set {s} median {statistics.median(v)!r} spread "
                 f"{spread(v):.5f} without the farthest "
                 f"{spread(without_farthest(v)):.5f} min {min(v)!r} max "
                 f"{max(v)!r}" for s, v in by.items() if len(v) >= 3]
        every = [x for v in by.values() for x in v]
        ratio = statistics.median(by[sets[-1]]) / \
            statistics.median(by[sets[0]])
        print(f"{m}: " + " | ".join(parts) + f" | all runs spread "
              f"{spread(every):.5f} | last / first median {ratio:.5f}")
    for r in rows:
        if r["set"] == 0 and r["result"]:
            print(f"trace seed {r['seed']}: " + json.dumps(
                {k: v["value"] for k, v in r["result"]["metrics"].items()}))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload")
    ap.add_argument("--seeds", default="")
    ap.add_argument("--sets", type=int, default=2)
    ap.add_argument("--seconds", type=float, default=10)
    ap.add_argument("--traces", default="")
    ap.add_argument("--out")
    ap.add_argument("--read")
    a = ap.parse_args(argv)
    if a.read:
        with open(a.read) as f:
            read([json.loads(line) for line in f])
        return 0
    seeds = [int(s) for s in a.seeds.split(",") if s]
    traces = [int(s) for s in a.traces.split(",") if s]
    os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
    first = one(a.workload, 1, 1, 0, f"{a.out}_build.log")
    print(f"first run: rc {first['rc']}", flush=True)
    plan = [(s, seed, 0) for s in range(1, a.sets + 1) for seed in seeds]
    plan += [(0, seed, 1) for seed in traces]
    rows = []
    with open(a.out + ".jsonl", "w") as f:
        for s, seed, trace in plan:
            r = dict(set=s, seed=seed, **one(a.workload, seed, a.seconds,
                                              trace, f"{a.out}_{s}_{seed}.log"))
            rows.append(r)
            f.write(json.dumps(r) + "\n")
            f.flush()
            res = r["result"]
            print(f"set {s} seed {seed} rc {r['rc']} " + (json.dumps(
                {"correct": res["correct"], "attempted": res["attempted"],
                 **{k: v["value"] for k, v in res["metrics"].items()}})
                if res else ""), flush=True)
    read(rows)
    return 0


if __name__ == "__main__":
    sys.exit(main())
