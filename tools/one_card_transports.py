"""Which torch.distributed transports take two ranks on one CUDA card.

Run from the repository root on a machine with a CUDA card:

    python3 tools/one_card_transports.py

chip_smoke.py's sharded phase runs its ranks over gloo when the machine
has one card, on the assumption that NCCL refuses two ranks on one GPU
and that gloo takes CUDA tensors (staging them through the host). This
script checks both: for each of nccl and gloo it spawns two ranks on
card 0 that all-gather and all-reduce a small CUDA tensor, and prints
one JSON line per transport with each rank's outcome (the values, or
the error's first line). It exits 0 when gloo works and NCCL refuses,
1 otherwise.
"""

from __future__ import annotations

import datetime
import json
import os
import sys
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

TIMEOUT_S = 60.0


def _rank(rank: int, backend: str, tmp: str) -> None:
    torch.cuda.set_device(0)
    out = {"rank": rank}
    try:
        dist.init_process_group(
            backend, init_method=f"file://{os.path.join(tmp, 'store')}",
            world_size=2, rank=rank,
            timeout=datetime.timedelta(seconds=TIMEOUT_S))
        x = torch.full((4,), float(rank + 1), device="cuda:0")
        parts = [torch.empty_like(x) for _ in range(2)]
        dist.all_gather(parts, x)
        dist.all_reduce(x)
        torch.cuda.synchronize()
        out["gathered"] = [float(p[0]) for p in parts]
        out["reduced"] = float(x[0])
    except Exception as e:  # the outcome is the result: report it
        out["error"] = f"{type(e).__name__}: {str(e).splitlines()[0]}"
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()
    with open(os.path.join(tmp, f"{rank}.json"), "w") as f:
        json.dump(out, f)


def try_transport(backend: str) -> list:
    """Each rank's outcome of two ranks over `backend` on card 0."""
    with tempfile.TemporaryDirectory(prefix="one_card_") as tmp:
        ctx = mp.start_processes(_rank, args=(backend, tmp), nprocs=2,
                                 join=False, start_method="spawn")
        try:
            done = ctx.join(timeout=2 * TIMEOUT_S)
        except mp.ProcessException as e:
            done = f"{type(e).__name__}: {str(e).strip().splitlines()[-1]}"
        finally:
            for p in ctx.processes:
                if p.is_alive():
                    p.terminate()
                p.join(30)
        outs = []
        for r in range(2):
            path = os.path.join(tmp, f"{r}.json")
            if os.path.exists(path):
                with open(path) as f:
                    outs.append(json.load(f))
            else:
                outs.append({"rank": r, "error": f"no outcome ({done})"})
        return outs


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("one_card_transports: no CUDA device")
    res = {b: try_transport(b) for b in ("gloo", "nccl")}
    for b, outs in res.items():
        print(json.dumps({"transport": b, "ranks_on_card_0": 2,
                          "card": torch.cuda.get_device_name(0),
                          "outcomes": outs}), flush=True)
    gloo_ok = all(o.get("gathered") == [1.0, 2.0] and o.get("reduced") == 3.0
                  for o in res["gloo"])
    nccl_refused = all("error" in o for o in res["nccl"])
    print(json.dumps({"gloo_takes_cuda_tensors": gloo_ok,
                      "nccl_refuses_two_ranks_on_one_card": nccl_refused}),
          flush=True)
    return 0 if gloo_ok and nccl_refused else 1


if __name__ == "__main__":
    sys.exit(main())
