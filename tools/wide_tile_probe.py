"""Where the time of K1-wide's diagonal tile goes, on the GPU.

Builds a copy of csrc/wide_factor.cu with clock stamps in the first
CTA of wide_tile_kernel and wide_rows_kernel (into build/), runs
bs_wide_factor on one panel with no below rows (by default FLAT-like:
cp 3072, real width 2,985, f64) and prints, for a few diagonal tiles,
the SM cycles of each phase: the load and step k - 1's update of the
tile until warp 0 starts the first diagonal block (`load`; `warm`: warp
0's call of the diagonal routine on scratch beside it), each 32-column
sub-block's diagonal factor (`chol0` ..), the rows below it (`below0`
..), the trailing update beside the next factor (`upd0` ..: it holds
`chol1` ..), the write-back left after the last sub-block (`store`), the
whole tile in cycles (`total`) and in ns of the global timer
(`total_ns`); and for the rows grid its staging and its products. The
anchors follow csrc/wide_factor.cu: edit both together. Every stamp is
thread 0's (the SM's schedulers keep clocks of their own, so stamps of
different warps do not compare). One JSON line per tile, then the
card's name, power limit and SM clock. Run from the repository root:

    python3 tools/wide_tile_probe.py [CP N [float32|float64]]

(BAL 871's widest panel: `4096 4095`.)
"""

import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "baspacho_tpu_torch", "csrc", "wide_factor.cu")
OUT = os.path.join(ROOT, "build", "wide_tile_probe")
SLOTS = 40  # stamps per tile


def instrumented() -> str:
    s = open(SRC).read()
    s = s.replace('#include "warp_tiles.cuh"',
                  f'#include "{os.path.dirname(SRC)}/warp_tiles.cuh"\n'
                  f"__device__ long long g_probe[64 * {SLOTS}];\n"
                  "#define STAMP(slot) do { if (blockIdx.x == 0 && "
                  "blockIdx.y == 0 && threadIdx.x == 0) { long long t_; "
                  'asm volatile("mov.u64 %0, %%clock64;" : "=l"(t_) :: '
                  '"memory"); g_probe[(k0 / 128) * '
                  f"{SLOTS} + (slot)] = t_; }} }} while (0)\n"
                  "#define GSTAMP(slot) do { if (blockIdx.x == 0 && "
                  "blockIdx.y == 0 && threadIdx.x == 0) { long long t_; "
                  'asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t_) :: '
                  '"memory"); g_probe[(k0 / 128) * '
                  f"{SLOTS} + (slot)] = t_; }} }} "
                  "while (0)\n")

    def put(anchor, text, after=True, start=0):
        i = s.index(anchor, start)
        j = i + len(anchor) if after else i
        return s[:j] + text + s[j:]
    tile = s.index("wide_tile_kernel(T* data")
    s = put("{", "\n  STAMP(0); GSTAMP(30);", start=tile)
    s = put("    if (nbs > 0) diag_chol_inv(warm, warm + kSub * kTld - 1, "
            "warm, 1);", "\n    STAMP(14);", start=tile)
    s = put("  if (warp == 0 && nbs > 0) factor_diag(0);", "  STAMP(1);\n",
            after=False, start=tile)
    call = ("    diag_chol_inv(A + p0 * kLd + p0, dxs + p0, xd(p), "
            "min(kSub, w - p0));")
    s = put(call, "\n    __syncwarp(); STAMP(20 + 2 * p);", start=tile)
    s = put(call, "    __syncwarp(); STAMP(21 + 2 * p);\n", after=False,
            start=tile)
    s = put("  if (warp == 0 && nbs > 0) factor_diag(0);\n  __syncthreads();",
            "\n  STAMP(2);", start=tile)
    s = put("{ a[r * kLd + c] = v; });\n    }\n    __syncthreads();",
            "\n    STAMP(3 + 2 * p);", start=tile)
    s = put("      store(p0 - kSub, p0, 4 * 32, 32);\n    }\n"
            "    __syncthreads();", "\n    STAMP(4 + 2 * p);", start=tile)
    s = put("  store(max(nbs - 1, 0) * kSub, kNb, 0, kTileCta);",
            "\n  __syncthreads(); STAMP(16); GSTAMP(31);", start=tile)
    rows = s.index("wide_rows_kernel(T* data")
    s = put("{", "\n  STAMP(17);", start=rows)
    s = put("  cp_async_commit();\n  cp_async_wait<0>();\n  __syncthreads();",
            "\n  STAMP(18);", start=rows)
    s = put("inv ? -v : v;\n  });", "\n  STAMP(19);", start=rows)
    return s + ('\nextern "C" int probe_read(long long* h) { return (int)'
                "cudaMemcpyFromSymbol(h, g_probe, sizeof(long long) * 64 * "
                f"{SLOTS}); }}\n")


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("wide_tile_probe: no CUDA device")
    os.makedirs(OUT, exist_ok=True)
    cu, so = os.path.join(OUT, "probe.cu"), os.path.join(OUT, "probe.so")
    with open(cu, "w") as f:
        f.write(instrumented())
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-shared",
                    "-o", so, cu], check=True)
    lib = ctypes.CDLL(so)
    i64, i32, vp = ctypes.c_int64, ctypes.c_int, ctypes.c_void_p
    lib.bs_wide_factor.argtypes = [i32, vp, i64, vp, vp, vp, vp, i64, i32,
                                   i32, i32, vp]
    lib.probe_read.argtypes = [vp]
    dev = torch.device("cuda:0")
    cp, n = (int(v) for v in sys.argv[1:3]) if len(sys.argv) > 2 else \
        (3072, 2985)
    dt = getattr(torch, sys.argv[3]) if len(sys.argv) > 3 else torch.float64
    g = torch.Generator(device=dev).manual_seed(0)
    a = torch.randn(n, n, device=dev, dtype=torch.float64, generator=g)
    P = torch.zeros(cp, cp, device=dev, dtype=torch.float64)
    P[:n, :n] = torch.tril(a @ a.T + n * torch.eye(n, device=dev,
                                                   dtype=torch.float64))
    P = P.to(dt)
    ix = lambda v: torch.tensor(v, dtype=torch.int64, device=dev)
    off, rows, cols = ix([0]), ix([0]), ix([n])
    xk = torch.empty(2 * 128 * 128, device=dev, dtype=dt)
    for _ in range(3):
        w = P.reshape(1, -1).clone()
        err = lib.bs_wide_factor(int(dt == torch.float64), w.data_ptr(),
                                 w.shape[1], xk.data_ptr(),
                                 off.data_ptr(), rows.data_ptr(),
                                 cols.data_ptr(), 1, cp, 0, 1,
                                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"bs_wide_factor: error {err}")
        torch.cuda.synchronize()
    h = (ctypes.c_longlong * (64 * SLOTS))()
    if lib.probe_read(ctypes.addressof(h)):
        raise RuntimeError("probe_read failed")
    nt = cp // 128
    print(json.dumps({"cp": cp, "n": n, "dtype": str(dt)[6:]}))
    for k in sorted({1, nt // 4, nt // 2, nt - 2}):
        s = [h[k * SLOTS + j] for j in range(SLOTS)]
        d = lambda a_, b_: s[b_] - s[a_]
        out = {"tile": k, "load": d(0, 1), "warm": d(0, 14),
               "store": d(10, 16), "total": d(0, 16), "total_ns": d(30, 31)}
        for p in range(4):
            out[f"chol{p}"] = d(21 + 2 * p, 20 + 2 * p)
            out[f"below{p}"] = d(2 + 2 * p, 3 + 2 * p)
            out[f"upd{p}"] = d(3 + 2 * p, 4 + 2 * p)
        out["rows_stage"], out["rows_products"] = d(17, 18), d(18, 19)
        print(json.dumps(out))
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                        "clocks.sm", "--format=csv,noheader"],
                       capture_output=True, text=True)
    print(q.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
