"""Build, load and launch the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain ``extern "C"`` interface and loaded with
``ctypes`` (no PyTorch headers, so a build takes seconds).  The build runs
at first use, into ``build/panda_tpu_torch/`` at the repository root, keyed
on a hash of the sources and flags; nothing is built when the package is
imported.

Every launcher takes device pointers, sizes and the stream, launches on
``torch.cuda.current_stream()``, allocates nothing and returns
``cudaGetLastError()``; :func:`launch` raises on a non-zero code and counts
the launch in :data:`launches`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parents[2] / "build" / "panda_tpu_torch"
KERNELS = ("digits", "hist", "phase_a", "point_ops", "wscan", "fmul", "dft",
           "small_ntt", "dg3")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

# Kernel launches since the last reset_counts(), by kernel source name.
launches = {name: 0 for name in KERNELS}

_libs: dict = {}
_fns: dict = {}


def reset_counts() -> None:
    for k in launches:
        launches[k] = 0


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for f in (CSRC / "field.cuh", CSRC / f"{name}.cu"):
        h.update(f.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def _build(name: str) -> Path:
    out = _lib_path(name)
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stderr}")
    os.replace(tmp, out)
    return out


def build_all() -> float:
    """Build every kernel library (in parallel) and load it; returns the
    seconds taken."""
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as ex:
        list(ex.map(_build, KERNELS))
    for name in KERNELS:
        _load(name)
    return time.perf_counter() - t0


def _load(name: str):
    if name not in _libs:
        lib = ctypes.CDLL(str(_build(name)))
        lib.ptt_error_string.argtypes = [ctypes.c_int]
        lib.ptt_error_string.restype = ctypes.c_char_p
        _libs[name] = lib
    return _libs[name]


P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def _fn(name: str, symbol: str, argtypes):
    key = (name, symbol)
    if key not in _fns:
        f = getattr(_load(name), symbol)
        f.argtypes = list(argtypes) + [P]          # + stream
        f.restype = ctypes.c_int
        _fns[key] = f
    return _fns[key]


def launch(name: str, symbol: str, argtypes, args, device: torch.device):
    """Call launcher ``symbol`` of kernel library ``name`` on ``device``'s
    current stream; raise if it reports an error; count the launch."""
    f = _fn(name, symbol, argtypes)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = f(*args, stream)
    if rc != 0:
        msg = _libs[name].ptt_error_string(rc).decode()
        raise RuntimeError(f"{symbol}: CUDA error {rc}: {msg}")
    launches[name] += 1


def check_cuda(name: str, *tensors: torch.Tensor) -> None:
    """Wrapper-side checks before a launch: every tensor int32, contiguous
    and on one device."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"{name}: tensors on different devices")
        if t.dtype != torch.int32:
            raise TypeError(f"{name}: expected torch.int32, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name}: tensor not contiguous")


def check_words(name: str, spec, t: torch.Tensor) -> None:
    """Raise unless ``t`` holds elements of field ``spec`` as rows of words:
    shape (n_bytes / 4, ...), 8 for 32-byte elements and 12 for 48."""
    if t.shape[0] != spec.n_bytes // 4:
        raise ValueError(f"{name}: {spec.name} elements must be "
                         f"({spec.n_bytes // 4}, ...) words")


def on_cpu(name: str, t: torch.Tensor) -> bool:
    """True for a CPU tensor (take the plain version), False for a CUDA
    tensor (launch the kernel); any other device raises."""
    if t.device.type == "cpu":
        return True
    if t.device.type == "cuda":
        return False
    raise ValueError(f"{name}: unsupported device {t.device}")


# The fields the NTT kernels (fmul, dft, small_ntt) are built for, in the
# order of their field ids (csrc/field.cuh: 0 is Fr254, 1 is Fr377).
NTT_FIELDS = ("bn254_fr", "bls12_377_fr")
# The curves the MSM point kernels (phase_a, point_ops, wscan) are built for,
# in the order of their curve ids (csrc/field.cuh: Bn254, Bls12_377,
# Bls12_381), and the scalar fields of the digits kernel, in the order of its
# field ids (Fr254, Fr377, Fr381).
MSM_CURVES = ("bn254", "bls12_377", "bls12_381")
MSM_FIELDS = ("bn254_fr", "bls12_377_fr", "bls12_381_fr")


def kernel_field(name: str, spec, built_for) -> int:
    """The id of ``spec`` (a curve, or a field) among the ones kernel
    ``name`` is built for (its index in ``built_for``); any other raises
    NotImplementedError."""
    if spec.name not in built_for:
        raise NotImplementedError(
            f"{name}: the CUDA kernel is built for {', '.join(built_for)}, "
            f"not {spec.name}; what is left is in ROADMAP: the BLS12-381 "
            "scalar-field NTT kernels, and the MSM above 2^20 points")
    return built_for.index(spec.name)
