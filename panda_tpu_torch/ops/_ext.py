"""Build, load and launch the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain ``extern "C"`` interface and loaded with
``ctypes`` (no PyTorch headers: a build takes seconds, up to ~3 minutes for
the point kernels of phase_a.cu and wscan.cu).  The build runs at first use,
into ``build/panda_tpu_torch/`` at the repository root, keyed on a hash of
the sources and flags, and keeps ptxas's report beside each library;
nothing is built when the package is imported.

Every launcher takes device pointers, sizes and the stream, launches on
``torch.cuda.current_stream()``, allocates nothing and returns
``cudaGetLastError()``; :func:`launch` raises on a non-zero code and counts
the launch in :data:`launches`.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD = Path(__file__).resolve().parents[2] / "build" / "panda_tpu_torch"
KERNELS = ("digits", "hist", "phase_a", "buckets", "point_ops", "wscan",
           "fmul", "dft", "small_ntt", "dg3")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")

# Kernel launches since the last reset_counts(), by kernel source name.
launches = {name: 0 for name in KERNELS}

_libs: dict = {}
_fns: dict = {}
# resident_threads' answers: {(name, symbol, kid, device index): threads}
_waves: dict = {}


def reset_counts() -> None:
    for k in launches:
        launches[k] = 0


def nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return path


def _lib_path(name: str, defines: tuple = ()) -> Path:
    h = hashlib.sha256(" ".join(NVCC_FLAGS + defines).encode())
    for f in (CSRC / "field.cuh", CSRC / f"{name}.cu"):
        h.update(f.read_bytes())
    return BUILD / f"lib{name}-{h.hexdigest()[:16]}.so"


def ptxas_log(name: str, defines: tuple = ()) -> Path:
    """The build's ``ptxas -v`` report of kernel library ``name``: each
    entry's registers, stack frame and spills."""
    return _lib_path(name, defines).with_suffix(".ptxas.txt")


def ptxas_rows(name: str, defines: tuple = ()) -> list:
    """(entry, registers, stack, spill stores, spill loads) of each kernel
    entry in the build's ptxas report (bytes a thread)."""
    rows, entry, frame = [], None, (0, 0, 0)
    for line in ptxas_log(name, defines).read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores,"
                      r" (\d+) bytes spill loads", line)
        if m:
            frame = tuple(int(v) for v in m.groups())
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            rows.append((entry, int(m.group(1)), *frame))
            entry, frame = None, (0, 0, 0)
    return rows


def _build(name: str, defines: tuple = ()) -> Path:
    out = _lib_path(name, defines)
    if out.exists():
        return out
    BUILD.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc(), *NVCC_FLAGS, *defines, "-o", str(tmp),
           str(CSRC / f"{name}.cu")]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{res.stderr}")
    ptxas_log(name, defines).write_text(res.stderr)
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


def _open(path: Path):
    lib = ctypes.CDLL(str(path))
    lib.ptt_error_string.argtypes = [ctypes.c_int]
    lib.ptt_error_string.restype = ctypes.c_char_p
    return lib


def _load(name: str):
    if name not in _libs:
        _libs[name] = _open(_build(name))
    return _libs[name]


@contextlib.contextmanager
def variant(name: str, defines: tuple):
    """Within the block, kernel library ``name`` is its build with the
    extra nvcc ``defines`` (``-D`` flags: another launch bound, for a
    measurement); launches count as usual."""
    lib = _open(_build(name, defines))
    saved = _libs.get(name), {k: f for k, f in _fns.items() if k[0] == name}
    for k in saved[1]:
        del _fns[k]
    _forget_waves(name)
    _libs[name] = lib
    try:
        yield
    finally:
        for k in [k for k in _fns if k[0] == name]:
            del _fns[k]
        _forget_waves(name)
        _fns.update(saved[1])
        if saved[0] is None:
            del _libs[name]
        else:
            _libs[name] = saved[0]


P, I64, I32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int


def _fn(name: str, symbol: str, argtypes):
    key = (name, symbol)
    if key not in _fns:
        f = getattr(_load(name), symbol)
        f.argtypes = list(argtypes)
        f.restype = ctypes.c_int
        _fns[key] = f
    return _fns[key]


def _check(name: str, symbol: str, rc: int) -> None:
    if rc != 0:
        msg = _libs[name].ptt_error_string(rc).decode()
        raise RuntimeError(f"{symbol}: CUDA error {rc}: {msg}")


def launch(name: str, symbol: str, argtypes, args, device: torch.device):
    """Call launcher ``symbol`` of kernel library ``name`` on ``device``'s
    current stream; raise if it reports an error; count the launch."""
    f = _fn(name, symbol, list(argtypes) + [P])        # + stream
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = f(*args, stream)
    _check(name, symbol, rc)
    launches[name] += 1


def resident_threads(name: str, symbol: str, kid: int,
                     device: torch.device) -> int:
    """Threads of one full wave of kernel library ``name``'s kernel ``kid``
    (a curve or field id; for hist, its bin count) on ``device``: the
    device's SMs times the blocks an SM that the build's registers and
    shared memory allow, as its function ``symbol`` reports them (asked
    once a build and device: a one-point launch's wrapper reads it too)."""
    key = (name, symbol, kid, device.index if device.index is not None
           else torch.cuda.current_device())
    if key not in _waves:
        f = _fn(name, symbol, [I32, ctypes.POINTER(ctypes.c_int)])
        out = ctypes.c_int(0)
        with torch.cuda.device(device):
            rc = f(kid, ctypes.byref(out))
        _check(name, symbol, rc)
        if out.value <= 0:
            raise RuntimeError(f"{symbol}: no block of the kernel fits an SM")
        _waves[key] = out.value
    return _waves[key]


def _forget_waves(name: str) -> None:
    for k in [k for k in _waves if k[0] == name]:
        del _waves[k]


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
# order of their field ids (csrc/field.cuh: 0 is Fr254, 1 is Fr377, 2 is
# Fr381).
NTT_FIELDS = ("bn254_fr", "bls12_377_fr", "bls12_381_fr")
# The curves the MSM point kernels (phase_a, buckets, point_ops, wscan) are
# built for, in the order of their curve ids (csrc/field.cuh: Bn254,
# Bls12_377, Bls12_381), and the scalar fields of the digits kernel, in the
# order of its field ids (Fr254, Fr377, Fr381).
MSM_CURVES = ("bn254", "bls12_377", "bls12_381")
MSM_FIELDS = ("bn254_fr", "bls12_377_fr", "bls12_381_fr")


def kernel_field(name: str, spec, built_for) -> int:
    """The id of ``spec`` (a curve, or a field) among the ones kernel
    ``name`` is built for (its index in ``built_for``); any other raises
    NotImplementedError."""
    if spec.name not in built_for:
        raise NotImplementedError(
            f"{name}: the CUDA kernel is built for {', '.join(built_for)}, "
            f"not {spec.name}")
    return built_for.index(spec.name)
