"""Where the time of K4's staged long-destination grid goes, on the GPU.

dense_block_kernel is K4's f32 grid for long destinations, and was its
f64 one before the tensor cores' grid (PERF.md §6); this probe runs
it on f64 data. It builds copies of csrc/dense_level.cu (into
build/dense_block_probe/) whose dense_block_kernel<double>, launched
through an entry of their own, adds clock64() stamps: thread 0 of each
CTA sums the SM cycles it spends issuing a chunk's cp.async staging
(`issue`), waiting for the chunk and the barrier (`wait`), summing the
chunk's records from shared memory with the barrier after (`compute`),
and its whole run (`total`). Two more copies drop the compute loop
(`stage_only`) or the staging (`compute_only`, on whatever shared memory
holds). Each runs the long destinations of the point level of a BAL
scene at BAL 871's density (window 24, track 5, loop closures 3 %, 605
points a camera; 200 cameras by default) on random data, f64, and
prints one JSON line per copy: ms by CUDA events (mean of 5 after 2
warm-up runs) and, for the stamped copy, the CTAs' cycle sums and their
shares, and cycles per record; then the card's name, power limit and SM
clock. Run from the repository root:

    python3 tools/dense_block_probe.py [n_cams]
"""

import ctypes
import json
import os
import subprocess
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
SRC = os.path.join(ROOT, "baspacho_tpu_torch", "csrc", "dense_level.cu")
OUT = os.path.join(ROOT, "build", "dense_block_probe")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-shared"]

STAGE_LOOP = """      if (ci + 1 < nchunk) {
        stage(ci + 1);  // its buffer was last read in chunk ci - 1
        cp_async_wait<1>();
      } else {
        cp_async_wait<0>();
      }
      __syncthreads();
"""
COMPUTE_END = "      __syncthreads();  // chunk ci's buffer may be refilled\n"
ENTRY = """
extern "C" int probe_set(long long* p) {
  return (int)cudaMemcpyToSymbol(g_probe, &p, sizeof(p));
}
extern "C" int probe_block(double* data, int64_t bstride,
                           const int64_t* list, int64_t n_list,
                           const int64_t* rec, const int64_t* dst_off,
                           const int64_t* dst_ld, const int64_t* dst_rows,
                           const int64_t* dst_cols, const int64_t* dst_ptr,
                           const int64_t* dst_nk, void* stream) {
  const size_t smem = 2 * kStageBytes + kBlockThreads * sizeof(double);
  cudaError_t e = cudaFuncSetAttribute(
      dense_block_kernel<double>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dense_block_kernel<double><<<dim3((unsigned)n_list, 1), kBlockThreads,
                               smem, static_cast<cudaStream_t>(stream)>>>(
      data, bstride, list, rec, dst_off, dst_ld, dst_rows, dst_cols,
      dst_ptr, dst_nk);
  return (int)cudaGetLastError();
}
"""


def variant(kind: str) -> str:
    """The source of one copy: "stamped", "stage_only" or
    "compute_only"."""
    s = open(SRC).read()
    here = os.path.dirname(SRC)
    s = s.replace('#include "warp_tiles.cuh"',
                  f'#include "{here}/warp_tiles.cuh"\n'
                  "__device__ long long* g_probe;")
    k = s.index("dense_block_kernel(T* data")
    head, body = s[:k], s[k:]
    stamped = kind == "stamped"
    clk = "clock64()" if stamped else "0"

    def sub(old, new):
        nonlocal body
        assert old in body, old
        body = body.replace(old, new, 1)
    sub("  const int tid = threadIdx.x, nt = kBlockThreads;\n",
        "  const int tid = threadIdx.x, nt = kBlockThreads;\n"
        f"  long long c_all = {clk}, c_issue = 0, c_wait = 0, c_comp = 0, "
        "c_ = 0;\n")
    first = "" if kind == "compute_only" else "stage(0);"
    sub("    stage(0);\n",
        f"    c_ = {clk}; {first} c_issue += {clk} - c_;\n")
    stage_next = "" if kind == "compute_only" else "stage(ci + 1);"
    wait1 = "" if kind == "compute_only" else "cp_async_wait<1>();"
    wait0 = "" if kind == "compute_only" else "cp_async_wait<0>();"
    sub(STAGE_LOOP,
        f"      c_ = {clk};\n"
        "      if (ci + 1 < nchunk) {\n"
        f"        {stage_next}\n"
        f"        c_issue += {clk} - c_; c_ = {clk};\n"
        f"        {wait1}\n"
        "      } else {\n"
        f"        {wait0}\n"
        "      }\n"
        "      __syncthreads();\n"
        f"      c_wait += {clk} - c_; c_ = {clk};\n")
    if kind == "stage_only":
        sub("      if (live) {\n        for (int j = g; j < n; j += G) {",
            "      if (false) {\n        for (int j = g; j < n; j += G) {")
    sub(COMPUTE_END, COMPUTE_END + f"      c_comp += {clk} - c_;\n")
    # the kernel's closing brace, by brace matching
    depth, i = 0, body.index("{")
    while True:
        depth += {"{": 1, "}": -1}.get(body[i], 0)
        if depth == 0:
            break
        i += 1
    body = (body[:i] +
            "  if (tid == 0 && blockIdx.y == 0 && g_probe) {\n"
            "    long long* o = g_probe + 4 * blockIdx.x;\n"
            f"    o[0] = c_issue; o[1] = c_wait; o[2] = c_comp; "
            f"o[3] = {clk} - c_all;\n"
            "  }\n" + body[i:])
    return head + body + ENTRY


def build(kind: str) -> ctypes.CDLL:
    os.makedirs(OUT, exist_ok=True)
    cu, so = (os.path.join(OUT, f"{kind}.{x}") for x in ("cu", "so"))
    with open(cu, "w") as f:
        f.write(variant(kind))
    nvcc = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                        "bin", "nvcc")
    subprocess.run([nvcc, *NVCC_FLAGS, "-o", so, cu], check=True)
    lib = ctypes.CDLL(so)
    vp = ctypes.c_void_p
    lib.probe_set.argtypes = [vp]
    lib.probe_block.argtypes = [vp, ctypes.c_int64, vp, ctypes.c_int64,
                                *[vp] * 7, vp]
    return lib


def point_level(n_cams: int, dev):
    """(data, DevDense) of the point level of a BAL scene at BAL 871's
    density, the data random."""
    import baspacho_tpu_torch as T
    from baspacho_tpu_torch.bal import make_random_bal
    from baspacho_tpu_torch.testing.flows import ba_optimizer, ba_settings
    prob = make_random_bal(n_cams=n_cams, n_pts=605 * n_cams, track_len=5,
                           seed=1, track_mode="window", window=24,
                           loop_frac=0.03)
    s = ba_optimizer(prob, ba_settings(T.BackendType.PLANNED, 1),
                     dev).solver
    levels = s.backend._factor_levels(0, s.skel.num_lumps, dev)
    d = next(lv.dense for lv in levels if lv.dense is not None)
    g = torch.Generator(device=dev).manual_seed(0)
    data = torch.rand((1, s.data_size), device=dev, dtype=torch.float64,
                      generator=g)
    return data, d


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("dense_block_probe: no CUDA device")
    dev = torch.device("cuda:0")
    n_cams = int(sys.argv[1]) if len(sys.argv) > 1 else 200
    data, d = point_level(n_cams, dev)
    n_long = d.dst_long.shape[0]
    records = int(d.dst_ptr.diff()[d.dst_long].sum())
    stamps = torch.zeros(4 * n_long, dtype=torch.int64, device=dev)
    st = torch.cuda.current_stream().cuda_stream
    for kind in ("stamped", "stage_only", "compute_only"):
        lib = build(kind)
        if lib.probe_set(stamps.data_ptr() if kind == "stamped" else None):
            raise RuntimeError("probe_set failed")

        def run():
            err = lib.probe_block(
                data.data_ptr(), data.shape[1], d.dst_long.data_ptr(),
                n_long, d.rec.data_ptr(), d.dst_off.data_ptr(),
                d.dst_ld.data_ptr(), d.dst_rows.data_ptr(),
                d.dst_cols.data_ptr(), d.dst_ptr.data_ptr(),
                d.dst_nk.data_ptr(), st)
            if err:
                raise RuntimeError(f"probe_block ({kind}): error {err}")
        for _ in range(2):
            run()
        torch.cuda.synchronize()
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(5):
            run()
        b.record()
        torch.cuda.synchronize()
        out = {"copy": kind, "n_cams": n_cams, "long_destinations": n_long,
               "records": records, "ms": a.elapsed_time(b) / 5}
        if kind == "stamped":
            tot = stamps.view(-1, 4).sum(0).tolist()
            out.update({k: v for k, v in zip(
                ("issue_cycles", "wait_cycles", "compute_cycles",
                 "total_cycles"), tot)})
            out.update({f"{k}_share": v / tot[3] for k, v in zip(
                ("issue", "wait", "compute"), tot[:3])})
            out["cta_cycles_per_record"] = tot[3] / records
        print(json.dumps(out), flush=True)
    q = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,"
                        "clocks.sm", "--format=csv,noheader"],
                       capture_output=True, text=True)
    print(q.stdout.strip())
    return 0


if __name__ == "__main__":
    sys.exit(main())
