"""Error codes: the port's own copy of ``panda_tpu/runtime/errors.py``.

The codes mirror the reference CUDA library's ``panda_error`` status enum;
Python callers get exceptions carrying them.
"""

from __future__ import annotations

import enum


class PandaError(enum.IntEnum):
    SUCCESS = 0
    INVALID_VALUE = 1
    MEMORY_ALLOCATION = 2
    NOT_READY = 3
    INVALID_DEVICE = 4
    INVALID_CONFIGURATION = 5
    UNSUPPORTED_CURVE = 6
    UNSUPPORTED_SIZE = 7
    NOT_INITIALIZED = 8
    INTERNAL = 9


class PandaRuntimeError(RuntimeError):
    def __init__(self, code: PandaError, msg: str = ""):
        self.code = code
        super().__init__(f"{code.name}: {msg}" if msg else code.name)
