"""Engine worker of the port: the accelerated engine behind the native C ABI.

Counterpart of ``panda_tpu/interop/worker.py``, speaking its protocol byte
for byte.  ``libpanda_host.so`` (``panda_tpu/native/panda_host.cpp``)
starts one worker a session with execution target 1, as
``$PANDA_WORKER_PYTHON -m panda_tpu.interop.worker``; pointing
``PANDA_WORKER_PYTHON`` at this package's launcher (``interop/worker_python``)
starts this module in its place.  The worker serves the port's byte API
(``runtime.api``) on the card, ``cuda:0``, or on the CPU when
``PANDA_WORKER_DEVICE=cpu``; it keeps its sessions (device tables, NTT
plans, built kernels) across calls.  With ``PANDA_WORKER_LAUNCHES`` naming
a file, the worker writes there, before each reply, its kernel launches
since it started (``ops._ext.launches``, JSON), so a caller can see which
kernels served a request.

Protocol (all integers little-endian):
  request  = u32 cmd | u32 curve_len | curve utf-8 | body
    cmd 1 (MSM): u64 slen | scalars | u64 blen | bases
    cmd 2 (NTT): u32 log_n | u32 inverse | u32 has_omega |
                 [32-byte omega if has_omega] | u64 len | data
    cmd 0 (PING): empty body
  reply    = i32 rc | u64 outlen | out-bytes
rc values are PandaError codes (``runtime/errors.py``), 0 = success.  A
PING opens the curve's session, so a worker whose device does not exist
answers it with INVALID_DEVICE.  Any other exception maps to INTERNAL (9)
with an empty payload, its traceback on stderr; the worker never crashes on
malformed work.  A cmd 2 with a root runs ``api.ntt_v1``, which takes the
stagewise engine for a zero root.
"""

from __future__ import annotations

import json
import os
import struct
import sys
import traceback


def _read_exact(f, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = f.read(n - len(buf))
        if not chunk:
            raise EOFError
        buf += chunk
    return buf


def _write_launches(path: str) -> None:
    from ..ops import _ext
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(_ext.launches, f)
    os.replace(tmp, path)


def serve(inp, out, device=None, launches=None) -> None:
    """Answer requests from binary stream ``inp`` on ``out`` until EOF, on
    ``device`` (default ``cuda:0``); with ``launches`` a path, write the
    kernel launches so far there before each reply."""
    from ..curves.config import CURVES
    from ..runtime import api
    from ..runtime.errors import PandaError, PandaRuntimeError
    from ..runtime.manager import PandaManager

    managers: dict[str, PandaManager] = {}

    def manager(curve: str) -> PandaManager:
        if curve not in managers:
            managers[curve] = PandaManager.new(0, curve, device)
        return managers[curve]

    def reply(rc: int, payload: bytes = b"") -> None:
        if launches:
            _write_launches(launches)
        out.write(struct.pack("<iQ", rc, len(payload)))
        out.write(payload)
        out.flush()

    while True:
        try:
            head = _read_exact(inp, 8)
        except EOFError:
            return                          # clean shutdown: C side closed
        cmd, clen = struct.unpack("<II", head)
        curve = _read_exact(inp, clen).decode() if clen else ""
        try:
            if cmd == 0:                    # ping / warmup: opens the session
                manager(curve)
                reply(0)
            elif cmd == 1:                  # MSM
                (slen,) = struct.unpack("<Q", _read_exact(inp, 8))
                scalars = _read_exact(inp, slen)
                (blen,) = struct.unpack("<Q", _read_exact(inp, 8))
                bases = _read_exact(inp, blen)
                reply(0, api.msm(manager(curve), scalars, bases))
            elif cmd == 2:                  # NTT / INTT / v1
                log_n, inverse, has_omega = struct.unpack(
                    "<III", _read_exact(inp, 12))
                omega = (_read_exact(inp, CURVES[curve].fr.n_bytes)
                         if has_omega else None)
                (dlen,) = struct.unpack("<Q", _read_exact(inp, 8))
                data = _read_exact(inp, dlen)
                gm = manager(curve)         # after the whole request is read
                if inverse:
                    res = api.intt(gm, data, log_n)
                elif omega is not None:
                    res = api.ntt_v1(gm, data, log_n, omega)
                else:
                    res = api.ntt(gm, data, log_n)
                reply(0, res)
            else:
                reply(int(PandaError.INVALID_VALUE))
        except PandaRuntimeError as e:
            reply(int(e.code))
        except EOFError:
            return
        except Exception:                   # the boundary that keeps serving
            traceback.print_exc(file=sys.stderr)
            sys.stderr.flush()
            reply(int(PandaError.INTERNAL))


def main() -> None:
    # Binary stdio; all diagnostics go to stderr.
    serve(sys.stdin.buffer, sys.stdout.buffer,
          os.environ.get("PANDA_WORKER_DEVICE") or None,
          os.environ.get("PANDA_WORKER_LAUNCHES") or None)


if __name__ == "__main__":
    main()
