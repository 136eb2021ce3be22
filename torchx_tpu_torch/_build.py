"""Build and load the port's hand-written kernels, and count their launches.

CUDA C++ sources under ``csrc/`` are compiled on first use with ``nvcc``
for ``sm_90a`` into a shared library with a plain C interface, loaded with
:mod:`ctypes` (pointers and the CUDA stream passed as ``c_void_p``). The
library's file name carries a hash of the sources, so an edited source is
never served by a stale build. Triton kernels compile on their first launch
into ``TRITON_CACHE_DIR``, which points into the same build directory unless
the caller set it. A failed build raises: nothing falls back.

Every kernel wrapper calls :func:`count_launch` right after its kernel was
launched, and nowhere else, so a run can show that the main path went
through the kernels (:func:`reset_launches` / :func:`launch_counts`).
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

PKG_DIR = Path(__file__).resolve().parent
CSRC_DIR = PKG_DIR / "csrc"
BUILD_DIR = PKG_DIR / "build"

#: nvcc flags: Hopper's arch-specific target, a plain shared library.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

#: Kernel names, in the order of the training step's path.
KERNELS = ("flash_fwd", "flash_dq", "flash_dkv", "norm_res_fwd", "rms_norm_bwd")

_LAUNCHES = dict.fromkeys(KERNELS, 0)
_lock = threading.Lock()
_lib = None
#: What the last build did: seconds, library path and nvcc's output.
build_info: dict = {}


def count_launch(name: str) -> None:
    """Add one to ``name``'s launch count (called by kernel wrappers only)."""
    _LAUNCHES[name] += 1


def reset_launches() -> None:
    """Set every kernel's launch count to 0."""
    for k in _LAUNCHES:
        _LAUNCHES[k] = 0


def launch_counts() -> dict[str, int]:
    """A copy of the launch counts, by kernel name."""
    return dict(_LAUNCHES)


def setup_triton_cache() -> None:
    """Point Triton's cache into the build directory unless already set."""
    os.environ.setdefault("TRITON_CACHE_DIR", str(BUILD_DIR / "triton"))


def _nvcc() -> str:
    cuda_home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    for cand in (
        Path(cuda_home) / "bin" / "nvcc" if cuda_home else None,
        shutil.which("nvcc"),
        "/usr/local/cuda/bin/nvcc",
    ):
        if cand and Path(cand).exists():
            return str(cand)
    raise RuntimeError(
        "nvcc not found (set CUDA_HOME): the port's CUDA kernels are built"
        " from csrc/ on first use and have no fallback"
    )


def _sources() -> list[Path]:
    return sorted(CSRC_DIR.glob("*.cu")) + sorted(CSRC_DIR.glob("*.cuh"))


def _declare(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    # tensors..., then batch, seq, heads, kv_heads, head_dim, causal, dtype,
    # then the stream
    ints = [i] * 7
    lib.tpx_flash_fwd.argtypes = [p] * 5 + ints + [p]
    lib.tpx_flash_dq.argtypes = [p] * 7 + ints + [p]
    lib.tpx_flash_dkv.argtypes = [p] * 8 + ints + [p]
    for fn in (lib.tpx_flash_fwd, lib.tpx_flash_dq, lib.tpx_flash_dkv):
        fn.restype = i
    lib.tpx_cuda_error_string.argtypes = [i]
    lib.tpx_cuda_error_string.restype = ctypes.c_char_p


def build() -> float:
    """Compile ``csrc/*.cu`` (unless already built) and load the library.

    -> seconds spent in ``nvcc`` (0.0 when the build was cached)."""
    global _lib
    with _lock:
        if _lib is not None:
            return 0.0
        srcs = _sources()
        digest = hashlib.sha256()
        for s in srcs:
            digest.update(s.name.encode() + s.read_bytes())
        digest.update(" ".join(NVCC_FLAGS).encode())
        so = BUILD_DIR / f"libtpx_kernels-{digest.hexdigest()[:16]}.so"
        seconds = 0.0
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            tmp = so.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp)] + [
                str(s) for s in srcs if s.suffix == ".cu"
            ]
            t0 = time.monotonic()
            proc = subprocess.run(cmd, capture_output=True, text=True)
            seconds = time.monotonic() - t0
            build_info.update(
                seconds=seconds, cmd=cmd, log=proc.stdout + proc.stderr
            )
            if proc.returncode != 0:
                raise RuntimeError(
                    f"nvcc failed ({proc.returncode}):\n{proc.stderr[-4000:]}"
                )
            os.replace(tmp, so)
        build_info["library"] = str(so)
        lib = ctypes.CDLL(str(so))
        _declare(lib)
        _lib = lib
        return seconds


def cuda_lib() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    if _lib is None:
        build()
    return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C launcher returned a CUDA error code."""
    if rc != 0:
        msg = cuda_lib().tpx_cuda_error_string(rc).decode()
        raise RuntimeError(f"{what} launch failed: CUDA error {rc} ({msg})")
