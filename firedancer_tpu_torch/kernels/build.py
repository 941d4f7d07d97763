"""Build the port's CUDA kernels at first use and load them with ctypes.

Every ``csrc/*.cu`` file becomes its own shared library with a plain C
interface, compiled by ``nvcc`` for ``sm_90a``; all the ``nvcc`` processes
start together.  The libraries go to ``firedancer_tpu_torch/_build/<hash>``,
keyed by a hash of every source file and the flags, so a changed source
rebuilds and an unchanged one loads at once.  ``ptxas -v`` output (each
kernel's registers, shared memory and spills) is kept in a ``.log`` file
beside each library and returned by ``build_all``.
"""

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD = PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc() -> str:
    for cand in (os.environ.get("CUDA_HOME", ""), "/usr/local/cuda"):
        path = Path(cand) / "bin" / "nvcc"
        if cand and path.exists():
            return str(path)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return found


def sources() -> list[str]:
    return sorted(p.stem for p in CSRC.glob("*.cu"))


def _src_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.iterdir()):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def build_all() -> dict[str, str]:
    """Compile every csrc/*.cu that is not built yet, all at once.
    Returns {source name: the nvcc/ptxas log of its build}."""
    out = BUILD / _src_hash()
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in sources():
        if (out / f"lib{name}.so").exists():
            continue
        tmp = out / f"lib{name}.{os.getpid()}.tmp"
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    errors = []
    for name, (proc, tmp) in procs.items():
        log, _ = proc.communicate()
        (out / f"{name}.log").write_text(log)
        if proc.returncode:
            errors.append(f"nvcc failed on {name}.cu:\n{log}")
        else:
            os.replace(tmp, out / f"lib{name}.so")
    if errors:
        raise RuntimeError("\n".join(errors))
    return {name: (out / f"{name}.log").read_text()
            for name in sources() if (out / f"{name}.log").exists()}


def load(name: str) -> ctypes.CDLL:
    """The shared library built from csrc/<name>.cu (built on first use)."""
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            build_all()
            lib = ctypes.CDLL(str(BUILD / _src_hash() / f"lib{name}.so"))
            _libs[name] = lib
        return lib
