#!/usr/bin/env python3
"""Where the float32 attention kernels spend their time, per block, on a card.

    python3 experiments/torch/attention_stamps.py [--csrc DIR] [--label LABEL]

Reads ``flash_attention.cu`` and ``flash_attention_bwd.cu`` from DIR
(default: this checkout's ``src/repro_torch/csrc``), writes copies under
``build/attention_stamps/`` in which thread 0 of every block records
``clock64()`` and ``%globaltimer`` at the kernel's entry, after each
``__syncthreads()`` of the kernel body and at its end (after one more
barrier), builds them with ``nvcc`` and runs them at the predictor's shape
(B 256, S = T = 10, K 2, G 1, D 32, causal): medians over 25 launches of
each phase's cycles per block, and the span of a launch on the globaltimer.
It also reads the device time of an empty kernel on the same grids (the
floor of any launch), the SM clock and power beside a timing loop
(``nvidia-smi``), and checks that the stamped kernels give the same bits
as the unstamped ones.  Both launcher interfaces are taken: the first
kernels' (every shape argument passed) and the later ones' (a pointer to
the shape arguments).  Prints one JSON line headed LABEL and the card.
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
OUT = ROOT / "build" / "attention_stamps"
B, S, T, KH, G, D = 256, 10, 10, 2, 1, 32

STAMP = ("if (threadIdx.x == 0) {{ g_st[blockIdx.x * 32 + {i}] = clock64(); "
         "g_st[blockIdx.x * 32 + 16 + {i}] = repro_gtime(); }}")
PRELUDE = """
__device__ long long* g_st;
__device__ __forceinline__ unsigned long long repro_gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
extern "C" int repro_stamps_set(void* st) { return (int)cudaMemcpyToSymbol(g_st, &st, sizeof(st)); }
__global__ void repro_empty_kernel() {}
extern "C" int repro_empty(int grid, int threads, void* stream) {
  repro_empty_kernel<<<grid, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}
"""


def stamped(src: str, kernel: str) -> tuple[str, int]:
    """``src`` with stamps in the body of ``__global__`` function ``kernel``;
    returns the source and the number of stamps."""
    start = re.search(r"__global__[^{]*\b" + kernel + r"\(", src).start()
    body = src.index("{", src.index(")", start)) + 1
    depth, end = 1, body
    while depth:
        depth += {"{": 1, "}": -1}.get(src[end], 0)
        end += 1
    inner = src[body:end - 1]
    n = 1
    pieces = inner.split("__syncthreads();")
    out = STAMP.format(i=0) + pieces[0]
    for piece in pieces[1:]:
        out += "__syncthreads();" + STAMP.format(i=n) + piece
        n += 1
    out += "__syncthreads();" + STAMP.format(i=n)
    text = src[:body] + out + src[end - 1:]
    include = text.index("\n", text.index("#include <cuda_runtime.h>")) + 1
    return text[:include] + PRELUDE + text[include:], n + 1


def build(csrc: Path) -> dict:
    OUT.mkdir(parents=True, exist_ok=True)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.kernels._lib import LIBRARY, NVCC_FLAGS

    libs = {}
    for name, kernel in (("fwd", "fa_fwd_kernel"), ("bwd", "fa_bwd_kernel")):
        src = (csrc / ("flash_attention.cu" if name == "fwd" else "flash_attention_bwd.cu")).read_text()
        text, n = stamped(src, kernel)
        path = OUT / f"stamped_{name}.cu"
        path.write_text(text)
        so = OUT / f"libstamped_{name}.so"
        out = subprocess.run([LIBRARY.nvcc(), *NVCC_FLAGS, "-shared", str(path), "-o", str(so)],
                             capture_output=True, text=True)
        if out.returncode:
            raise SystemExit(f"nvcc failed on {path}:\n{out.stderr}")
        libs[name] = (ctypes.CDLL(str(so)), n, "const void* args" in src)
    return libs


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--csrc", type=Path, default=ROOT / "src" / "repro_torch" / "csrc")
    ap.add_argument("--label", default="stamps")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("attention_stamps: needs a CUDA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as CS

    dev = torch.device("cuda", 0)
    libs = build(args.csrc)
    rng = np.random.default_rng(5)
    mk = lambda *s: torch.tensor(rng.standard_normal(s).astype(np.float32), device=dev)
    q, k, v, do = mk(B, S, KH, G, D), mk(B, T, KH, D), mk(B, T, KH, D), mk(B, S, KH, G, D)
    scale = float(torch.tensor(D ** -0.5, dtype=torch.float32))
    stream = torch._C._cuda_getCurrentRawStream(0)
    P, I, F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float

    class Args(ctypes.Structure):
        _fields_ = [(n, I) for n in ("B", "S", "T", "K", "G", "D", "causal", "q_offset", "kv_len")] + [("scale", F)]

    shape_args = Args(B, S, T, KH, G, D, 1, 0, T, scale)
    nblk = B * KH
    st = torch.zeros(nblk * 32, dtype=torch.int64, device=dev)
    result = {"card": CS.nvidia_smi_line(), "csrc": str(args.csrc)}
    for name, (lib, n, struct) in libs.items():
        fn = getattr(lib, "repro_flash_attention_f32" if name == "fwd" else "repro_flash_attention_bwd_f32")
        outs = [torch.empty_like(q)] if name == "fwd" else [torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)]
        ptrs = [t.data_ptr() for t in ([q, k, v] if name == "fwd" else [q, k, v, do]) + outs]
        if struct:
            fn.argtypes = (P,) * (len(ptrs) + 2)
            call = lambda: fn(*ptrs, ctypes.addressof(shape_args), stream)
        else:
            fn.argtypes = (P,) * len(ptrs) + (I,) * 9 + (F, P)
            call = lambda: fn(*ptrs, B, S, T, KH, G, D, 1, 0, T, scale, stream)
        lib.repro_stamps_set.argtypes = (P,)
        assert lib.repro_stamps_set(st.data_ptr()) == 0
        phases, spans, marks = [], [], None
        for i in range(30):
            st.zero_()
            assert call() == 0
            torch.cuda.synchronize()
            a = st.view(nblk, 32).cpu().numpy()
            if i < 5:
                continue
            # the stamps this shape reached (a barrier in a branch the shape skips records nothing)
            marks = [j for j in range(n) if a[:, j].any()]
            phases = phases or [[] for _ in marks[1:]]
            for j, (u, w) in enumerate(zip(marks, marks[1:])):
                phases[j].extend((a[:, w] - a[:, u]).tolist())
            spans.append(int(a[:, 16 + marks[-1]].max() - a[:, 16].min()))
        sys.path.insert(0, str(ROOT / "src"))
        from repro_torch.kernels import flash_attention as K

        want = [K.flash_attention(q, k, v)] if name == "fwd" else list(K.flash_attention_bwd(q, k, v, do))
        result[name] = {"stamps_reached": marks, "phase_cycles": [float(np.median(x)) for x in phases],
                        "block_cycles": float(np.median(np.sum(phases, axis=0))),
                        "span_ns": float(np.median(spans)),
                        "same_bits_as_unstamped": all(torch.equal(x, y) for x, y in zip(outs, want))}
    empty = libs["fwd"][0].repro_empty
    empty.argtypes = (I, I, P)
    result["empty_kernel_ms"] = {}
    for threads in (32, 96, 128, 160, 256, 320):
        prof = CS.profiled(lambda: empty(nblk, threads, stream), 200)
        t = sum(x for x, _ in CS.device_times(prof).values())
        result["empty_kernel_ms"][f"{nblk}x{threads}"] = t / 200 * 1e3
    smi = subprocess.Popen(["nvidia-smi", "--query-gpu=clocks.sm,power.draw", "--format=csv,noheader,nounits",
                            "-lms", "100"], stdout=subprocess.PIPE, text=True)
    try:
        t_end = time.time() + 2.0
        while time.time() < t_end:
            K.flash_attention(q, k, v)
        torch.cuda.synchronize()
    finally:
        smi.terminate()
        lines = [ln for ln in smi.communicate(timeout=10)[0].splitlines() if ln.strip()]
    sm = [float(ln.split(",")[0]) for ln in lines]
    result["sm_clock_mhz"] = {"samples": len(sm), "min": min(sm), "max": max(sm)} if sm else None
    print(f"{args.label}: " + json.dumps(result))
    print(result["card"])
    return 0


if __name__ == "__main__":
    sys.exit(main())
