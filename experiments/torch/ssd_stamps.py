#!/usr/bin/env python3
"""Where the SSD scan kernels spend their time, per block, on a card.

    python3 experiments/torch/ssd_stamps.py [--label LABEL] [--dtype bfloat16|float32]

Reads this checkout's ``src/repro_torch/csrc/ssd_scan.cu`` and writes a copy
under ``build/ssd_stamps/`` in which thread 0 of every block of every
``__global__`` kernel records ``clock64()`` at the kernel's entry, after
each ``__syncthreads()`` of the kernel body (a "site", numbered in the
order of the source) and at its end (after one more barrier), and
``%globaltimer`` at entry and end.  Barriers inside loops are reached many
times, so the copy keeps, per block, the cycles and the visits of each
*transition* between two sites (the work between them): at the serve shape
(B 2, L 2048, H 32, P 64, N 128, chunk 256) the transition of the single
kernel of the first port from its C-tile load to its first key tile is
its ``y_inter``, from the weights to the next key tile its ``w . x``, and
so on; each site is printed
with its source line and the text after the barrier, so that a reader can
name the work.  The copy is built with ``nvcc``, bound in place of the
kernel library behind this checkout's ``kernels/ssd_scan.py`` wrapper, and
launched through the wrapper (3 warm-ups, then 10 launches).  Prints, per
kernel, the median over blocks and launches of each transition's cycles per
launch and its visits per block, the median span of a launch on the
globaltimer, and whether the stamped build gives the same bits as the
unstamped one; then the device time of an empty kernel on the same grids
(the floor of any launch) and the SM clock and power beside a timing loop
(``nvidia-smi``).  One JSON line headed LABEL, then the card.

To read another checkout's kernels, run its copy of this script (copy it
into that checkout first), so that each tree's wrapper drives its own
kernels.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[2]
OUT = ROOT / "build" / "ssd_stamps"
SERVE = (2, 2048, 32, 64, 128, 256)  # B, L, H, P, N, chunk: one layer of the mamba2-370m prefill
MAX_SITES = 14  # sites per kernel (entry, barriers, end)
MAX_BLOCKS = 4096  # blocks per kernel with a row of their own (more share the last)
MAX_KERNELS = 4
LAUNCHES, WARMUP = 10, 3
# per block, 32-bit words: cycles and visits per transition, then the entry
# and end globaltimer (two words each; the row stays 8-byte aligned)
ROW = MAX_SITES * MAX_SITES * 2 + 4

PRELUDE = """
__device__ unsigned int* g_st;
__device__ __forceinline__ unsigned long long repro_gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned int* repro_row(int kernel) {
  long long b = blockIdx.x + (long long)gridDim.x * (blockIdx.y + (long long)gridDim.y * blockIdx.z);
  if (b >= MAX_BLOCKS) b = MAX_BLOCKS - 1;
  return g_st + ((long long)kernel * MAX_BLOCKS + b) * ROW;
}
__device__ __forceinline__ void repro_stamp(unsigned int* row, int& last, long long& t_last, int site) {
  const long long t = clock64();
  row[(last * MAX_SITES + site) * 2] += (unsigned int)(t - t_last);
  row[(last * MAX_SITES + site) * 2 + 1] += 1u;
  last = site;
  t_last = t;
}
extern "C" int repro_stamps_set(void* st) { return (int)cudaMemcpyToSymbol(g_st, &st, sizeof(st)); }
__global__ void repro_empty_kernel() {}
extern "C" int repro_empty(int grid, int threads, void* stream) {
  repro_empty_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
""".replace("MAX_BLOCKS", str(MAX_BLOCKS)).replace("MAX_SITES", str(MAX_SITES)).replace("ROW", str(ROW))

ENTRY = ("unsigned int* repro_r = repro_row({k}); int repro_last = 0; long long repro_t = clock64(); "
         "if (threadIdx.x == 0) {{ *(unsigned long long*)(repro_r + {g0}) = repro_gtime(); }}")
SITE = "if (threadIdx.x == 0) {{ repro_stamp(repro_r, repro_last, repro_t, {i}); }}"
END = ("__syncthreads(); if (threadIdx.x == 0) {{ repro_stamp(repro_r, repro_last, repro_t, {i}); "
       "*(unsigned long long*)(repro_r + {g1}) = repro_gtime(); }}")


def kernels_in(src: str) -> list[str]:
    return re.findall(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?(\w+)\s*\(", src)


def stamped(src: str) -> tuple[str, dict]:
    """``src`` with stamps in the body of every ``__global__`` kernel; returns
    the source and, per kernel, its index and its sites (source line and the
    text after the barrier)."""
    g0 = MAX_SITES * MAX_SITES * 2  # the globaltimer words, at the end of the row (two 32-bit words each)
    info = {}
    for k, name in enumerate(kernels_in(src)):
        m = re.search(r"__global__\s+void\s+(?:__launch_bounds__\([^)]*\)\s+)?" + name + r"\s*\(", src)
        body = src.index("{", src.index(")", m.end())) + 1
        depth, end = 1, body
        while depth:
            depth += {"{": 1, "}": -1}.get(src[end], 0)
            end += 1
        inner = src[body:end - 1]
        line0 = src[:body].count("\n") + 1
        sites = [{"site": 0, "line": line0, "after": "entry"}]
        pieces = inner.split("__syncthreads();")
        out = ENTRY.format(k=k, g0=g0) + pieces[0]
        pos = len(pieces[0])
        for i, piece in enumerate(pieces[1:], start=1):
            line = line0 + inner[:pos].count("\n")
            nxt = " ".join(piece.strip().split())[:70]
            sites.append({"site": i, "line": line, "after": nxt})
            out += "__syncthreads();" + SITE.format(i=i) + piece
            pos += len("__syncthreads();") + len(piece)
        n_end = len(pieces)
        if n_end + 1 > MAX_SITES:
            raise SystemExit(f"{name} has {n_end} barriers; the stamps hold {MAX_SITES - 1}")
        sites.append({"site": n_end, "line": line0 + inner.count("\n"), "after": "end"})
        out += END.format(i=n_end, g1=g0 + 2)
        src = src[:body] + out + src[end - 1:]
        info[name] = {"index": k, "sites": sites}
    include = src.index("\n", src.index("#include <cuda_runtime.h>")) + 1
    return src[:include] + PRELUDE + src[include:], info


def build(csrc: Path):
    from repro_torch.kernels._lib import LIBRARY, NVCC_FLAGS

    OUT.mkdir(parents=True, exist_ok=True)

    text, info = stamped((csrc / "ssd_scan.cu").read_text())
    path = OUT / "stamped_ssd_scan.cu"
    path.write_text(text)
    so = OUT / "libstamped_ssd_scan.so"
    out = subprocess.run([LIBRARY.nvcc(), *NVCC_FLAGS, "-shared", str(path), "-o", str(so)],
                         capture_output=True, text=True)
    if out.returncode:
        raise SystemExit(f"nvcc failed on {path}:\n{out.stderr}")
    return ctypes.CDLL(str(so)), info


class StampedLibrary:
    """Stands in for ``kernels._lib.LIBRARY``: the same launchers, from the
    stamped build."""

    def __init__(self, cdll):
        from repro_torch.kernels import _lib

        self.cdll, self.signatures = cdll, _lib._SIGNATURES

    def call(self, fn: str, *args) -> None:
        f = getattr(self.cdll, fn)
        f.argtypes, f.restype = self.signatures[fn], ctypes.c_int
        code = f(*args)
        if code != 0:
            raise RuntimeError(f"stamped {fn} failed (code {code})")


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--label", default="ssd_stamps")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("ssd_stamps: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    sys.path.insert(0, str(ROOT / "src"))
    import chip_smoke as CS
    from repro_torch.kernels import ssd_scan as S

    dev = torch.device("cuda", 0)
    cdll, info = build(ROOT / "src" / "repro_torch" / "csrc")
    B, L, H, P, N, Q = SERVE
    dtype = {"bfloat16": torch.bfloat16, "float32": torch.float32}[args.dtype]
    x, dt, A_log, b, c = CS._ssd_inputs(dev, dtype, B, L, H, P, N, seed=11)
    want = S.ssd_scan(x, dt, A_log, b, c, chunk=Q)  # the unstamped library
    st = torch.zeros(MAX_KERNELS * MAX_BLOCKS * ROW, dtype=torch.int32, device=dev)
    if len(info) > MAX_KERNELS:
        raise SystemExit(f"ssd_scan.cu has {len(info)} kernels; the stamps hold {MAX_KERNELS}")
    cdll.repro_stamps_set.argtypes = (ctypes.c_void_p,)
    assert cdll.repro_stamps_set(st.data_ptr()) == 0
    real = S.LIBRARY
    S.LIBRARY = StampedLibrary(cdll)
    n_k = len(info)
    samples = []
    try:
        for i in range(WARMUP + LAUNCHES):
            st.zero_()
            got = S.ssd_scan(x, dt, A_log, b, c, chunk=Q)
            torch.cuda.synchronize()
            if i >= WARMUP:
                samples.append(st.view(MAX_KERNELS, MAX_BLOCKS, ROW)[:n_k].cpu().numpy().view(np.uint32))
    finally:
        S.LIBRARY = real
    same = torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    result = {"card": CS.nvidia_smi_line(), "dtype": args.dtype, "shape": dict(zip("BLHPNQ", SERVE)),
              "same_bits_as_unstamped": same, "kernels": {}}
    g0 = MAX_SITES * MAX_SITES * 2
    grids = set()
    for name, meta in info.items():
        k = meta["index"]
        t_in = np.stack([s[k, :, g0].astype(np.uint64) | (s[k, :, g0 + 1].astype(np.uint64) << np.uint64(32))
                         for s in samples])
        t_out = np.stack([s[k, :, g0 + 2].astype(np.uint64) | (s[k, :, g0 + 3].astype(np.uint64) << np.uint64(32))
                          for s in samples])
        entered = np.nonzero(t_in[0])[0]
        if entered.size == 0:
            continue  # not launched at this shape
        nblk = int(entered.max()) + 1
        grids.add(nblk)
        trans = np.stack([s[k, :nblk, :g0] for s in samples]).astype(np.int64)
        trans = trans.reshape(len(samples), nblk, MAX_SITES, MAX_SITES, 2)
        out = []
        for u in range(MAX_SITES):
            for w in range(MAX_SITES):
                visits = trans[:, :, u, w, 1]
                if visits.any():
                    cyc = trans[:, :, u, w, 0]
                    out.append({"from": u, "to": w, "cycles": float(np.median(cyc)),
                                "cycles_per_visit": float(np.median(cyc[visits > 0] / visits[visits > 0])),
                                "visits": float(np.median(visits))})
        spans = [int(t_out[i, :nblk].max() - t_in[i, :nblk].min()) for i in range(len(samples))]
        block_cycles = trans[..., 0].sum(axis=(2, 3))
        result["kernels"][name] = {"blocks": nblk, "sites": meta["sites"], "transitions": out,
                                   "block_cycles": float(np.median(block_cycles)),
                                   "block_cycles_max": float(np.median(block_cycles.max(axis=1))),
                                   "span_ns": float(np.median(spans))}
    empty = cdll.repro_empty
    empty.argtypes = (ctypes.c_int, ctypes.c_int, ctypes.c_void_p)
    stream = torch._C._cuda_getCurrentRawStream(0)
    result["empty_kernel_ms"] = {}
    for nblk in sorted(grids):
        for threads in (128, 256):
            prof = CS.profiled(lambda: empty(nblk, threads, stream), 200)
            t = sum(v for v, _ in CS.device_times(prof).values())
            result["empty_kernel_ms"][f"{nblk}x{threads}"] = t / 200 * 1e3
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
                            "-lms", "100"], stdout=subprocess.PIPE, text=True)
    try:
        t_end = time.time() + 2.0
        while time.time() < t_end:
            S.ssd_scan(x, dt, A_log, b, c, chunk=Q)
            torch.cuda.synchronize()
    finally:
        smi.terminate()
        lines = [ln for ln in smi.communicate(timeout=10)[0].splitlines() if ln.strip()]
    sm = [float(ln.split(",")[0]) for ln in lines]
    pw = [float(ln.split(",")[1]) for ln in lines]
    result["sm_clock_mhz"] = {"samples": len(sm), "min": min(sm), "max": max(sm)} if sm else None
    result["power_w"] = {"min": min(pw), "max": max(pw)} if pw else None
    result["device_ms"] = CS.device_ms(lambda: S.ssd_scan(x, dt, A_log, b, c, chunk=Q), "ssd_scan", iters=10)
    print(f"{args.label}: " + json.dumps(result))
    print(result["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
