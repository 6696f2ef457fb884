"""Build the CUDA kernels in ``csrc/`` at first use and load them with ctypes.

Each ``csrc/<name>.cu`` has a plain C interface and is compiled by its own
``nvcc`` process, all started together, into ``build/kernels/`` beside the
package (listed in ``.gitignore``). The library's file name carries a hash of
its source, the headers in ``csrc/`` and the flags, so an edited source or
header is rebuilt and an unchanged one is loaded as it is.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_I64 = ctypes.c_int64
# C signature of every exported function: name -> (source stem, argtypes)
SIGNATURES = {
    "lrp_linear_f32": ("lrp_linear", [_P, _P, _P, _P, _P, _P, _I64, _I, _I, _I, _P]),
    "lstm_gates_f32": ("lstm_gates", [_P, _P, _P, _P, _P, _P, _P, _I64, _I, _P]),
    "conv3x3_fused_f32": ("conv3x3_fused",
                          [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P]),
    # the dynamic shared memory (bytes) of the big (0) or the small (1) tile
    "conv3x3_fused_smem_bytes": ("conv3x3_fused", [_I]),
    "lrp_a1b0_fused_bf16": ("lrp_a1b0_fused", [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P]),
    # the dynamic shared memory (bytes) of the launch a layer with Cin channels takes
    "lrp_a1b0_fused_smem_bytes": ("lrp_a1b0_fused", [_I]),
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}
_fns: dict[str, ctypes._CFuncPtr] = {}
build_log: dict[str, str] = {}  # source stem -> nvcc's output (ptxas register/spill report)


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = Path(home) / "bin" / "nvcc"
    if path.exists():
        return str(path)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin): "
                       "the CUDA kernels are built on the machine with the card")


def _target(stem: str) -> Path:
    src = (CSRC / f"{stem}.cu").read_bytes()
    headers = b"".join(h.read_bytes() for h in sorted(CSRC.glob("*.cuh")))
    digest = hashlib.sha1(src + headers + " ".join(NVCC_FLAGS).encode()).hexdigest()[:12]
    return BUILD_DIR / f"{stem}-{digest}.so"


def build_all() -> dict[str, ctypes.CDLL]:
    """Compile (in parallel) whatever is not built yet and load every library."""
    with _lock:
        stems = sorted({stem for stem, _ in SIGNATURES.values()})
        missing = [s for s in stems if s not in _libs and not _target(s).exists()]
        if missing:
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            nvcc = _nvcc()
            procs = {}
            for stem in missing:
                tmp = _target(stem).with_suffix(f".{os.getpid()}.tmp")
                cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{stem}.cu")]
                procs[stem] = (tmp, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                     stderr=subprocess.STDOUT, text=True))
            failed = []
            for stem, (tmp, proc) in procs.items():
                log, _ = proc.communicate()
                build_log[stem] = log
                if proc.returncode != 0:
                    failed.append(f"{stem}.cu (rc {proc.returncode}):\n{log}")
                else:
                    os.replace(tmp, _target(stem))
            if failed:
                raise RuntimeError("nvcc failed for " + "\n".join(failed))
        for stem in stems:
            if stem not in _libs:
                _libs[stem] = ctypes.CDLL(str(_target(stem)))
        return _libs


def kernel_fn(name: str):
    """The exported C function ``name`` with its argtypes set (builds on first use)."""
    fn = _fns.get(name)
    if fn is None:
        stem, argtypes = SIGNATURES[name]
        fn = getattr(build_all()[stem], name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn
