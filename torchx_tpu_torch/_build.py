"""Build and load the port's hand-written kernels, and count their launches.

CUDA C++ sources under ``csrc/`` are compiled on first use with ``nvcc``
for ``sm_90a``, one ``nvcc`` per ``.cu`` file, all started together, then
linked into a shared library with a plain C interface, loaded with
:mod:`ctypes` (pointers and the CUDA stream passed as ``c_void_p``). The
headers (``csrc/*.cuh``) are included by the sources; the library links
nothing but the CUDA runtime (TMA descriptors are encoded through the CUDA
driver's entry point, which the runtime hands out). The library's file
name carries a hash of the sources and flags, so an edited source is never
served by a stale build. Triton kernels compile on their first launch into
``TRITON_CACHE_DIR``, which points into the same build directory unless
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

#: nvcc flags of each object: Hopper's arch-specific target (wgmma needs the
#: ``a``), position-independent code, ptxas's register and spill report.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

#: Kernel names, in the order of the training step's path. The flash
#: forward, dq and dk/dv come as two variants (``ops.fused.flash_variant``):
#: ``wgmma`` on the tensor cores, ``simt`` on the CUDA cores.
KERNELS = (
    "flash_fwd_wgmma", "flash_fwd_simt", "flash_dq_wgmma", "flash_dq_simt",
    "flash_dkv_wgmma", "flash_dkv_simt", "norm_res_fwd", "rms_norm_bwd",
)

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
    fns = {
        "tpx_flash_fwd": 5, "tpx_flash_fwd_wgmma": 5, "tpx_flash_dq": 7,
        "tpx_flash_dq_wgmma": 7, "tpx_flash_dkv": 8, "tpx_flash_dkv_wgmma": 8,
    }
    for name, n_tensors in fns.items():
        fn = getattr(lib, name)
        fn.argtypes = [p] * n_tensors + ints + [p]
        fn.restype = i
    lib.tpx_cuda_error_string.argtypes = [i]
    lib.tpx_cuda_error_string.restype = ctypes.c_char_p


def _run(cmds: list[list[str]]) -> str:
    """Run the commands side by side; raise if any fails. -> their output."""
    procs = [
        subprocess.Popen(c, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for c in cmds
    ]
    outs = [proc.communicate()[0] for proc in procs]
    for cmd, proc, out in zip(cmds, procs, outs):
        if proc.returncode != 0:
            raise RuntimeError(
                f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{out[-4000:]}"
            )
    return "".join(outs)


def _compile_and_link(srcs: list[Path], so: Path, tag: str) -> tuple[float, str]:
    """One nvcc per ``.cu`` file, all at once, then one link into ``so``.
    -> (seconds, nvcc's output)."""
    t0 = time.monotonic()
    pid = os.getpid()
    cus = [s for s in srcs if s.suffix == ".cu"]
    objs = [BUILD_DIR / f"{s.stem}-{tag}.{pid}.o" for s in cus]
    log = _run([
        [_nvcc(), *NVCC_FLAGS, "-c", "-o", str(o), str(s)] for s, o in zip(cus, objs)
    ])
    tmp = so.with_suffix(f".{pid}.tmp")
    log += _run([[_nvcc(), "-shared", "-o", str(tmp), *map(str, objs)]])
    os.replace(tmp, so)
    for o in objs:
        o.unlink()
    return time.monotonic() - t0, log


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
        tag = digest.hexdigest()[:16]
        so = BUILD_DIR / f"libtpx_kernels-{tag}.so"
        seconds = 0.0
        if not so.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            seconds, log = _compile_and_link(srcs, so, tag)
            build_info.update(seconds=seconds, log=log)
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
