"""Build the CUDA sources under ``src/repro_torch/csrc`` into one shared
library and load it with ``ctypes``.

The library has a plain C interface (no PyTorch headers), so ``nvcc``
builds it in seconds.  Each source compiles in its own ``nvcc`` process,
all started together, for ``sm_90a`` (Hopper); the objects link into
``build/torch_kernels/librepro_torch_kernels_<hash>.so`` at the root of the
checkout, where ``<hash>`` covers the sources and flags, so an edited
source never loads a stale build.  The build happens at first use and is
published with an atomic rename.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("evict_select.cu", "freq_table.cu", "flash_attention.cu", "decode_attention.cu", "ssd_scan.cu")
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_SIGNATURES = {
    "repro_evict_select": (_P, _P, _P, _P, _P, _P, _P, _I, _P),
    "repro_freq_update": (_P, _P, _P, _I, _I, _P),
    "repro_freq_lookup": (_P, _P, _P, _P, _I, _I, _P),
    "repro_flash_attention_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    "repro_flash_attention_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _I, _F, _P),
    "repro_decode_attention_f32": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    "repro_decode_attention_bf16": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F, _P),
    "repro_ssd_scan_f32": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
    "repro_ssd_scan_bf16": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P),
}


class KernelLibrary:
    """The built and loaded kernel library (one per process)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._cdll: ctypes.CDLL | None = None
        self.build_seconds: float | None = None  # None: loaded a build that already existed
        self.ptxas_log = ""

    @staticmethod
    def nvcc() -> str:
        home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH") or "/usr/local/cuda"
        cand = Path(home) / "bin" / "nvcc"
        found = str(cand) if cand.exists() else shutil.which("nvcc")
        if found is None:
            raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")
        return found

    @staticmethod
    def digest() -> str:
        h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
        for name in SOURCES:
            h.update(name.encode())
            h.update((CSRC / name).read_bytes())
        return h.hexdigest()[:16]

    def path(self) -> Path:
        return BUILD_DIR / f"librepro_torch_kernels_{self.digest()}.so"

    def build(self) -> Path:
        """Compile and link the library unless this source hash is built."""
        target = self.path()
        if target.exists():
            return target
        nvcc = self.nvcc()
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        tmp = BUILD_DIR / f"tmp.{os.getpid()}.{threading.get_ident()}"
        tmp.mkdir(exist_ok=True)
        t0 = time.perf_counter()
        try:
            procs = []
            for name in SOURCES:
                obj = tmp / (Path(name).stem + ".o")
                cmd = [nvcc, *NVCC_FLAGS, "-Xptxas", "-v", "-c", str(CSRC / name), "-o", str(obj)]
                procs.append((name, obj, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
            logs, errors = [], []
            for name, _, p in procs:
                out, err = p.communicate()
                logs.append(f"== {name}\n{out}{err}")
                if p.returncode != 0:
                    errors.append(f"nvcc failed on {name} (exit {p.returncode}):\n{out}{err}")
            if errors:
                raise RuntimeError("\n".join(errors))
            so = tmp / target.name
            link = subprocess.run([nvcc, *NVCC_FLAGS, "-shared", *(str(o) for _, o, _ in procs), "-o", str(so)],
                                  capture_output=True, text=True)
            if link.returncode != 0:
                raise RuntimeError(f"nvcc link failed (exit {link.returncode}):\n{link.stdout}{link.stderr}")
            os.replace(so, target)
        finally:
            shutil.rmtree(tmp, ignore_errors=True)
        self.build_seconds = time.perf_counter() - t0
        self.ptxas_log = "\n".join(logs)
        return target

    def cdll(self) -> ctypes.CDLL:
        with self._lock:
            if self._cdll is None:
                lib = ctypes.CDLL(str(self.build()))
                for fn, args in _SIGNATURES.items():
                    getattr(lib, fn).argtypes = args
                    getattr(lib, fn).restype = ctypes.c_int
                lib.repro_error_string.argtypes = (ctypes.c_int,)
                lib.repro_error_string.restype = ctypes.c_char_p
                self._cdll = lib
            return self._cdll

    def call(self, fn: str, *args) -> None:
        """Call one launcher; raise if it reports an error."""
        lib = self.cdll()
        code = getattr(lib, fn)(*args)
        if code != 0:
            msg = "unsupported shape" if code < 0 else lib.repro_error_string(code).decode()
            raise RuntimeError(f"{fn} failed: {msg} (code {code})")


LIBRARY = KernelLibrary()


def ptr(t) -> int | None:
    """Device pointer of a tensor (``None`` passes a null pointer)."""
    return None if t is None else t.data_ptr()


def stream_handle(device) -> int:
    import torch

    return torch.cuda.current_stream(device).cuda_stream
