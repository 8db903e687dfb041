"""Device/session manager.

Counterpart of ``panda_tpu/runtime/manager.py``: a ``PandaManager`` holds
the session's ``torch.device``, its cached MSM inputs and its NTT tables.
Bases, scalars and NTT data arrive as wire bytes (LE Montgomery, R = 2^256
for BN254's fields and the scalar fields, 2^384 for the BLS base fields),
which are already the port's internal form: ingest reinterprets the bytes as
(L, n) int32 words (L = 8 for 32-byte elements, 12 for the BLS curves'
48-byte coordinates) and, for bases, reduces each coordinate to [0, p) on
the session's device (``mont.reduce_wire``).
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import torch

from ..curves.config import BN254, CURVES, CurveSpec
from ..fields import mont
from ..ops import ntt as ntt_ops
from .errors import PandaError, PandaRuntimeError


class InitUnitType(enum.Enum):
    """``PandaGpuManagerInitUnitType``."""
    NONE = "none"
    MSM = "msm"
    NTT = "ntt"
    ALL = "all"


class ResultCoordinateType(enum.IntEnum):
    JACOBIAN = 0
    PROJECTIVE = 1


def get_device_number() -> int:
    """Number of CUDA devices visible to PyTorch."""
    return torch.cuda.device_count()


def device_info(device_id: int = 0) -> dict:
    """Name and memory of CUDA device ``device_id``."""
    if not 0 <= device_id < torch.cuda.device_count():
        raise PandaRuntimeError(PandaError.INVALID_DEVICE, str(device_id))
    free, total = torch.cuda.mem_get_info(device_id)
    return {"platform": "gpu",
            "device_kind": torch.cuda.get_device_name(device_id),
            "bytes_free": free, "bytes_limit": total}


def _resolve_device(device_id: int, device) -> torch.device:
    dev = torch.device(device if device is not None else f"cuda:{device_id}")
    if dev.type == "cuda":
        index = dev.index if dev.index is not None else device_id
        if not (torch.cuda.is_available()
                and 0 <= index < torch.cuda.device_count()):
            raise PandaRuntimeError(PandaError.INVALID_DEVICE, str(dev))
        return torch.device("cuda", index)
    if dev.type != "cpu":
        raise PandaRuntimeError(PandaError.INVALID_DEVICE, str(dev))
    return dev


@dataclass
class PandaManager:
    """Session object holding the device and cached inputs."""

    device_id: int = 0
    curve: CurveSpec = BN254
    result_coordinate_type: ResultCoordinateType = ResultCoordinateType.JACOBIAN
    d_bases: list = field(default_factory=list)      # (px, py) word tensors
    d_scalars: list = field(default_factory=list)    # (8, n) word tensors
    device: torch.device | None = None
    _ntt_tables: dict = field(default_factory=dict)
    _ntt_omega_override: int | None = None
    _initialized: bool = False

    # -- lifecycle ---------------------------------------------------------
    @classmethod
    def new(cls, device_id: int = 0, curve: str | CurveSpec = BN254,
            device=None) -> "PandaManager":
        """Hardware init only.  ``device`` defaults to ``cuda:<device_id>``;
        pass ``device="cpu"`` to run the plain versions."""
        gm = cls(device_id=device_id,
                 curve=CURVES[curve] if isinstance(curve, str) else curve)
        gm.init_hardware(device_id, device)
        return gm

    @classmethod
    def init_all(cls, device_id: int, unit: InitUnitType,
                 bases: list | None = None,
                 omega_bytes: bytes | None = None,
                 curve: str | CurveSpec = BN254,
                 device=None) -> "PandaManager":
        gm = cls.new(device_id, curve, device)
        if unit in (InitUnitType.MSM, InitUnitType.ALL) and bases is not None:
            gm.init_msm(bases)
        if unit in (InitUnitType.NTT, InitUnitType.ALL):
            gm.init_ntt(omega_bytes)
        return gm

    def init_hardware(self, device_id: int, device=None) -> None:
        """Select the device; raises INVALID_DEVICE when there is no such
        GPU (it never falls back to the CPU)."""
        self.device = _resolve_device(device_id, device)
        self.device_id = device_id
        self._initialized = True

    def _require_init(self):
        if not self._initialized:
            raise PandaRuntimeError(PandaError.NOT_INITIALIZED)

    # -- cached inputs -----------------------------------------------------
    def ingest_bases(self, blob: bytes):
        """Affine-point bytes (x || y per point) -> canonical (px, py)."""
        fp = self.curve.fp
        raw = memoryview(blob)
        stride = 2 * fp.n_bytes
        if len(raw) % stride:
            raise PandaRuntimeError(PandaError.INVALID_CONFIGURATION,
                                    "point byte length mismatch")
        w = mont.bytes_to_words(fp, raw)                 # (W, 2n): x, y, ...
        px = mont.words_tensor(w[:, 0::2], self.device)
        py = mont.words_tensor(w[:, 1::2], self.device)
        return mont.reduce_wire(fp, px), mont.reduce_wire(fp, py)

    def ingest_scalars(self, blob: bytes) -> torch.Tensor:
        """Scalar bytes -> (8, n) words; any value below 2^256 is taken,
        the digit recode reduces it."""
        try:
            w = mont.bytes_to_words(self.curve.fr, blob)
        except ValueError as e:
            raise PandaRuntimeError(PandaError.INVALID_CONFIGURATION, str(e))
        return mont.words_tensor(w, self.device)

    def init_msm(self, bases_sets: list) -> int:
        self._require_init()
        for blob in bases_sets:
            self.init_msm_cached_bases(blob)
        return len(self.d_bases)

    def init_msm_cached_bases(self, blob: bytes) -> int:
        self._require_init()
        self.d_bases.append(self.ingest_bases(blob))
        return len(self.d_bases) - 1

    def init_msm_cached_scalars(self, blob: bytes) -> int:
        self._require_init()
        self.d_scalars.append(self.ingest_scalars(blob))
        return len(self.d_scalars) - 1

    def init_msm_cached(self, bases_blob: bytes, scalars_blob: bytes) -> tuple:
        return (self.init_msm_cached_bases(bases_blob),
                self.init_msm_cached_scalars(scalars_blob))

    # -- NTT ---------------------------------------------------------------
    def init_ntt(self, omega_bytes: bytes | None = None) -> None:
        """Record the session's root (Montgomery LE bytes; default: the
        field's canonical root per size); tables build lazily per log_n."""
        self._require_init()
        if omega_bytes is not None:
            self._ntt_omega_override = self.root_from_bytes(omega_bytes)
        self._ntt_tables.clear()

    def root_from_bytes(self, omega_bytes: bytes) -> int:
        """A root given as Montgomery LE bytes -> its plain integer."""
        fr = self.curve.fr
        w = mont.words_to_ints(mont.bytes_to_words(fr, omega_bytes))[0]
        return fr.from_wire_int(w)

    def ntt_tables(self, log_n: int,
                   omega_int: int | None = None) -> ntt_ops.NttTables:
        """The cached tables for size 2^log_n and root ``omega_int`` (plain
        integer; default: the session's root, else the canonical one)."""
        fr = self.curve.fr
        omega = (omega_int if omega_int is not None
                 else self._ntt_omega_override)
        key = (fr.name, log_n, omega)
        if key not in self._ntt_tables:
            self._ntt_tables[key] = ntt_ops.make_tables(fr, log_n, omega)
        return self._ntt_tables[key]

    # -- config and lifecycle tail ----------------------------------------
    def set_config(self, coordinate_type: ResultCoordinateType) -> None:
        """Jacobian vs Projective output.  Results are affine-normalised
        (z = 1), where both encodings give the same bytes."""
        self.result_coordinate_type = ResultCoordinateType(coordinate_type)

    def sync(self) -> None:
        if self.device is not None and self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def deinit(self) -> None:
        self.d_bases.clear()
        self.d_scalars.clear()
        self._ntt_tables.clear()

    destroy = deinit

    def format_affine_result(self, pt) -> bytes:
        """Affine int point ((x, y) or None) -> the 3-field LE wire blob;
        the identity is (0, 1, 0)."""
        f = self.curve.fp
        x, y, z = (0, 1, 0) if pt is None else (*pt, 1)
        return b"".join(f.to_wire_int(v).to_bytes(f.n_bytes, "little")
                        for v in (x, y, z))
