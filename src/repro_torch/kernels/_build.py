"""Build and load the hand-written CUDA kernels.

Every ``csrc/*.cu`` source is compiled by ``nvcc`` for ``sm_90a`` (one
``nvcc`` process per source, all started together), linked into one shared
library with a plain C interface, and loaded with :mod:`ctypes`.  The build
runs at the first launch of any kernel, into ``build/kernels/`` at the root of
the checkout (listed in ``.gitignore``), and is keyed by a hash of the
sources, so an edited source rebuilds and concurrent processes never load a
half-written library.  Nothing here runs at import time.

This is the port's counterpart of an XLA compile: the seconds of the first
:func:`library` call of a process (the build, where one is needed, and the
``ctypes`` load) go to :func:`repro_torch.obs.device.add_build_seconds`,
which the fits' and the serving engine's ``compile_seconds`` read.
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
from typing import Dict, Optional

from ..obs import device as obs_device

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
ARCH_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a")
NVCC_FLAGS = ("-O3", "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
# ptxas register / shared-memory report of the last build, per source
build_log: Dict[str, str] = {}

_vp, _i, _ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
_ip = ctypes.POINTER(ctypes.c_int)
_SIGNATURES = {
    # A, X, parents, vars, ql0, c0, ql, c, scratch, border, m, L, n, K, bm,
    # group, fold, lanes, stream
    "repro_gram_update": [_vp] * 10 + [_ll, _i, _i, _i, _i, _i, _i, _i, _vp],
    # L, K
    "repro_gram_tiles": [_i, _i],
    "repro_gram_partial_floats": [_i, _i],
    # L, n
    "repro_gram_can_gather": [_i, _i],
    # N_in, N_out, q, btb, ell, active, u_scratch, L, lanes, stream
    "repro_ihb_update": [_vp] * 7 + [_i, _i, _vp],
    # QLt, C, N, Lcap, Kcap, ell0s (host), Ks (host), lanes, kstride, psi,
    # accepted, mses, coeffs, slots, ell_out, u_scratch, stream
    "repro_ihb_degree": [_vp] * 3 + [_i] * 2 + [_ip] * 2 + [_i, _i, ctypes.c_float]
    + [_vp] * 7,
    "repro_ihb_max_lanes": [],
    # rows, lanes
    "repro_ihb_lane_blocks": [_i, _i],
    # rows, K, rows_max, lanes
    "repro_ihb_degree_staged": [_i] * 4,
    # q, k, v, o, BHq, Sq, Sk, d, dv, group, causal, dtype, stream
    "repro_flash_attention": [_vp] * 4 + [_i] * 8 + [_vp],
    # dtype, d, dv
    "repro_flash_attention_variant": [_i, _i, _i],
    # X, labels, state, iters, partials, ticket, step, lam, tol, m, p, k,
    # max_iter, coef, grid, steps, stream
    "repro_fista_steps": [_vp] * 9 + [_ll, _i, _i, _i, ctypes.c_float, _i, _i, _vp],
    # m, p, k
    "repro_fista_grid": [_ll, _i, _i],
    # p, k
    "repro_fista_variant": [_i, _i],
}


_RESTYPES = {"repro_gram_partial_floats": ctypes.c_longlong}


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cand = Path("/usr/local/cuda/bin/nvcc")
    if cand.exists():
        return str(cand)
    raise RuntimeError(
        "nvcc not found: the CUDA kernels of repro_torch are built from "
        f"{CSRC} with the CUDA toolkit's nvcc (sm_90a)"
    )


def _sources():
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256()
    for src in _sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(ARCH_FLAGS + NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def _build(target: Path) -> None:
    nvcc = nvcc_path()
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}_{threading.get_ident()}"
    objs, procs = [], []
    for src in _sources():
        obj = BUILD_DIR / f"{src.stem}.{tag}.o"
        cmd = [nvcc, *ARCH_FLAGS, *NVCC_FLAGS, "-c", str(src), "-o", str(obj)]
        procs.append((src, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
        )))
        objs.append(obj)
    failed = []
    for src, proc in procs:
        out, _ = proc.communicate()
        build_log[src.name] = out
        if proc.returncode != 0:
            failed.append(f"{src.name}:\n{out}")
    if failed:
        raise RuntimeError("nvcc failed\n" + "\n".join(failed))
    tmp = target.with_name(f"{target.name}.{tag}.tmp")
    link = subprocess.run(
        [nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
    )
    for obj in objs:
        obj.unlink(missing_ok=True)
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed:\n{link.stdout}")
    (BUILD_DIR / f"{target.stem}.ptxas.txt").write_text(
        "\n".join(f"== {k}\n{v}" for k, v in build_log.items())
    )
    os.replace(tmp, target)


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            t0 = time.perf_counter()
            target = BUILD_DIR / f"librepro_torch_kernels_{_digest()}.so"
            if not target.exists():
                _build(target)
            lib = ctypes.CDLL(str(target))
            for name, argtypes in _SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = _RESTYPES.get(name, ctypes.c_int)
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            _lib = lib
            obs_device.add_build_seconds(time.perf_counter() - t0)
        return _lib


def check(err: int, name: str) -> None:
    """Raise if a C entry point returned a CUDA error."""
    if err != 0:
        msg = library().repro_cuda_error_string(err).decode()
        raise RuntimeError(f"{name}: CUDA error {err} ({msg})")
