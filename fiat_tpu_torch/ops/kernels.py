"""Build and load the hand-written CUDA kernels.

The sources in ``fiat_tpu_torch/csrc/*.cu`` (with the headers
``csrc/*.cuh`` they share) compile with ``nvcc`` for Hopper (``sm_90a``),
one ``nvcc`` per source, all started together, and link into ONE shared
library with a plain C interface, loaded with ``ctypes``.  The build
happens at first use, into ``build/fiat_tpu_torch/`` beside the package,
and is redone whenever a hash of the sources, headers and flags changes.
Without ``nvcc`` (a CPU-only machine) ``load_kernels`` raises
``RuntimeError``; importing the package never builds anything.

Every C entry point takes raw device pointers plus the caller's CUDA
stream, launches, and returns ``cudaGetLastError()``; the wrappers
(``recurrence.py``, ``fused_zoo.py``, ``macro_oneshot.py``,
``masked_matmul.py``, ``moment_kernel.py``, ``f32_zoo.py``, ``bernstein.py``) raise when it is
not 0.
"""

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parent.parent.parent / "build" / "fiat_tpu_torch"
ARCH_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH_FLAGS, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_D = ctypes.c_double
_F = ctypes.c_float
#: C signatures: name -> argtypes (all return int, the CUDA error code)
SIGNATURES = {
    # pts, npts, consts, slots, affine[2], scale, degree, phi, stream
    "fiat_dubiner1_values": [_P, _I, _P, _P, _D, _D, _D, _I, _P, _P],
    # pts, npts, consts, slots, owner, groups, points, affine[6], scale, degree, phi, stream
    "fiat_dubiner2_values": [_P, _I, _P, _P, _P, _I, _I, *[_D] * 6, _D, _I, _P, _P],
    # pts, npts, consts, slots, owner, groups, points, affine[12], scale, degree, phi, stream
    "fiat_dubiner3_values": [_P, _I, _P, _P, _P, _I, _I, *[_D] * 12, _D, _I, _P, _P],
    # sd, degree, grouped, points (returns blocks an SM, or minus the error)
    "fiat_dubiner_occupancy": [_I] * 4,
    # pts, npts, sd, degree, bary, coef, out, stream
    "fiat_bernstein_features": [_P, _I, _I, _I, _P, _P, _P, _P],
    # At, kpad, kmax, tp, kc, stages, minb, tiles, ntiles, phi, ldphi, npts, C, stream
    "fiat_bucket_matmul": [_P, _I, _I, _I, _I, _I, _I, _P, _I, _P, _I, _I, _P, _P],
    # At, kpad, kmax, kc, stages, group, tiles, ntiles, phi, ldphi, npts, C, stream
    "fiat_bucket_matmul_stream": [_P, _I, _I, _I, _I, _I, _P, _I, _P, _I, _I, _P, _P],
    # pts, npts, sd, consts, slots, affine[12] (host array), scale, tol, degree,
    # maps, pieces, slices, groups, ngroups, rc, sub, resident, stages, buf,
    # ring, nbar, words, At, gather (or null), out, tp, stream (in f64 / in f32)
    "fiat_macro_oneshot": [_P, _I, _I, _P, _P, _P, _D, _D, _I, _P, _P, _P, _P, *[_I] * 9,
                           _P, _P, _P, _I, _P],
    "fiat_macro_oneshot_f32": [_P, _I, _I, _P, _P, _P, _F, _F, _I, _P, _P, _P, _P,
                               *[_I] * 9, _P, _P, _P, _I, _P],
    # pts, wf, npts, sd, consts (host array), dconsts (device, or null),
    # slots, affine[12] (host array), scale, tol, degree, nplain, maps,
    # npieces, progs, nprogs, pieces, R, warps, nblocks, partials, tickets,
    # out, stream
    "fiat_pair_moments": [_P, _P, _I, _I, _P, _P, _P, _P, _D, _D, _I, _I, _P, _I, _P, _I, _P,
                          _I, _I, _I, _P, _P, _P, _P],
    # sd, degree, warps, piece rows, pieces, programs, plain rows in shared
    # memory (returns blocks an SM, or minus the error)
    "fiat_pair_moments_occupancy": [_I] * 7,
    # pts, npts, sd, tol, maps, progs, pieces, slices, nslices, At, phi, kmax, out,
    # tp, slice_cols, stages, words, stream
    "fiat_masked_matmul": [_P, _I, _I, _D, _P, _P, _P, _P, _I, _P, _P, _I, _P, _I, _I, _I, _I,
                           _P],
    # sd, kmax, tp, slice_cols, stages, words (returns blocks an SM, or minus the error)
    "fiat_masked_matmul_occupancy": [_I] * 6,
    # pts, npts, sd, consts, slots, affine[12] (host array), scale, degree, At, kpad,
    # kmax, tiles, ntiles, dst, out, tp, kc, stages, minb, stream
    "fiat_zoo_f32": [_P, _I, _I, _P, _P, _P, _F, _I, _P, _I, _I, _P, _I, _P, _P, _I, _I, _I, _I,
                     _P],
    # sd, degree, kpad, kmax, tp, kc, stages, minb (returns blocks an SM, or
    # minus the error)
    "fiat_zoo_f32_occupancy": [_I] * 8,
    # pts, npts, sd, consts, slots, affine[12] (host array), scale, degree, kpad,
    # kmax, phi, ldphi, stream
    "fiat_zoo_f32_phi": [_P, _I, _I, _P, _P, _P, _F, _I, _I, _I, _P, _I, _P],
    # At, kpad, kmax, tiles, ntiles, phi, ldphi, npts, dst, out, kc, stages, group, stream
    "fiat_zoo_f32_stream": [_P, _I, _I, _P, _I, _P, _I, _I, _P, _P, _I, _I, _I, _P],
    # kc, stages (returns blocks an SM, or minus the error)
    "fiat_zoo_f32_stream_occupancy": [_I] * 2,
}


def find_nvcc():
    """Path of the CUDA compiler (on PATH, else the toolkit's default
    location), or None."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    return str(default) if default.exists() else None


@functools.lru_cache(maxsize=1)
def load_kernels():
    """The loaded kernel library (built first if needed).  Attributes
    ``path`` and ``build_log`` (nvcc's output with ptxas register and
    spill counts; empty when a matching build existed)."""
    nvcc = find_nvcc()
    if nvcc is None:
        raise RuntimeError(
            "fiat_tpu_torch kernels need the CUDA compiler (nvcc), which was not "
            "found on PATH or in /usr/local/cuda/bin; the CUDA kernels only build "
            "on a machine with the CUDA toolkit and an sm_90 card")
    sources = sorted(CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    lib_path = BUILD_DIR / f"libfiat_tpu_torch_{h.hexdigest()[:16]}.so"
    log = ""
    if not lib_path.exists():
        log = _build(nvcc, sources, lib_path)
    lib = ctypes.CDLL(str(lib_path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.path = lib_path
    lib.build_log = log
    return lib


def _build(nvcc, sources, lib_path):
    """Compile every source with its own nvcc, all at once, then link them
    into ``lib_path``; returns nvcc's output (ptxas register counts)."""
    tag = f"{os.getpid()}.tmp"
    objs = [lib_path.with_name(f"{src.stem}.{tag}.o") for src in sources]
    procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                              stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
             for src, obj in zip(sources, objs)]
    outs = [proc.communicate()[0] for proc in procs]
    log = "".join(outs)
    try:
        for src, proc, out in zip(sources, procs, outs):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed on {src.name} ({proc.returncode}):\n{out}")
        tmp = lib_path.with_suffix(f".{tag}")
        proc = subprocess.run([nvcc, *ARCH_FLAGS, "-shared", "-o", str(tmp), *map(str, objs)],
                              capture_output=True, text=True)
        log += proc.stdout + proc.stderr
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{log}")
        os.replace(tmp, lib_path)
    finally:
        for obj in objs:
            obj.unlink(missing_ok=True)
    return log


def resolve_device(device):
    """The device of an engine or kernel wrapper: the one asked for, else
    the current CUDA card.  Without a card a missing device raises: the
    plain PyTorch versions run only where the caller asks for the CPU."""
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device: fiat_tpu_torch runs on the card unless asked otherwise; "
            "pass device=\"cpu\" for the kernels' plain PyTorch versions")
    return torch.device("cuda")


def check_launch(name, err):
    """Raise if a C entry point reported a CUDA error."""
    if err != 0:
        raise RuntimeError(f"{name}: CUDA launch failed with error {err}")


def stream_of(tensor):
    """The current CUDA stream handle on the tensor's device (an int)."""
    return torch.cuda.current_stream(tensor.device).cuda_stream


@contextlib.contextmanager
def no_tf32():
    """Float32 matrix products in full float32 (never TF32) inside the
    block: the plain versions of the f32 kernels, as fiat_tpu's
    ``Precision.HIGHEST``; the previous setting comes back after."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev
