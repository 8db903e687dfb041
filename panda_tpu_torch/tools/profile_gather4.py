"""The gather probe: the port of ``tools/profile_gather4.py``.

Two measurements, in the JAX tool's order:

1. the row gather ``tab[idx]`` of ``ni`` random rows of R words from an
   ``n``-row table, for R = 9, 12 and 16 32-bit words and for 8 64-bit
   words (``jnp.take(p, i, axis=0)`` in the JAX tool, an XLA gather; here
   ``index_select``).  At the default sizes this is the memory traffic of
   the MSM's phase A at 2^20 points: 2^24 lookups of a 64-byte point from
   a 64 MiB table;
2. ``dg3``, the per-column lookup ``out[g, i, c] = tab[g, idx[g, i, c], c]``
   on int32 (G, R, 128) tensors at depths R = 8, 32, 256 and 1024, with G
   chosen so that a launch makes ``lookups`` lookups (the JAX tool's Pallas
   kernel; here the CUDA kernel ``csrc/dg3.cu``).

Each case prints one line: its time a call over ``reps`` calls after one
warm-up (CUDA events on the card, the host clock on the CPU) and its rate.
Run it on the card:

    python -m panda_tpu_torch.tools.profile_gather4

``--device cpu`` runs the plain versions on the CPU instead, at the same
sizes (outputs of up to 1 GiB; the tests call :func:`main` with small
ones); with no GPU and no ``--device cpu`` it raises.
"""

from __future__ import annotations

import argparse
import time

import torch

from ..ops import _ext
from ..ops._ext import I32, I64, P

COLS = 128          # the lane width of dg3's tensors
ROW_WORDS = (9, 12, 16)
DEPTHS = (8, 32, 256, 1024)


def dg3_plain(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    return torch.gather(tab, 1, idx.long())


def dg3(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """out[g, i, c] = tab[g, idx[g, i, c], c] for int32 (G, R, 128) ``tab``
    and ``idx`` with indices in [0, R)."""
    cpu = _ext.on_cpu("dg3", tab)
    _ext.check_cuda("dg3", tab, idx)
    if tab.shape != idx.shape or tab.dim() != 3 or tab.shape[2] != COLS:
        raise ValueError(f"dg3: expected two (G, R, {COLS}) tensors, got "
                         f"{tuple(tab.shape)} and {tuple(idx.shape)}")
    if cpu:
        return dg3_plain(tab, idx)
    G, R, _ = tab.shape
    out = torch.empty_like(tab)
    _ext.launch("dg3", "ptt_dg3", [P, P, P, I64, I32],
                [tab.data_ptr(), idx.data_ptr(), out.data_ptr(), G, R],
                tab.device)
    return out


def row_gather(tab: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """Rows ``tab[idx]``: shape idx.shape + (R,), for an (n, R) int32 table
    (uint32 words as their bit patterns) or int64 table, and int32 indices
    in [0, n)."""
    if tab.dim() != 2 or tab.dtype not in (torch.int32, torch.int64):
        raise ValueError(f"row_gather: expected an (n, R) int32 or int64 "
                         f"table, got {tuple(tab.shape)} {tab.dtype}")
    if idx.dtype != torch.int32:
        raise TypeError(f"row_gather: expected int32 indices, got {idx.dtype}")
    return tab.index_select(0, idx.reshape(-1)).reshape(*idx.shape,
                                                        tab.shape[1])


def time_ms(fn, reps: int, device: torch.device) -> float:
    """Mean ms a call of ``fn()`` over ``reps`` back-to-back calls after one
    warm-up: CUDA events on a CUDA device, the host clock on the CPU.  Each
    result is dropped as soon as it is made."""
    fn()
    if device.type == "cuda":
        a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        torch.cuda.synchronize(device)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        torch.cuda.synchronize(device)
        return a.elapsed_time(b) / reps
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    return (time.perf_counter() - t0) * 1e3 / reps


def main(device: torch.device, n: int = 1 << 20, ni: int = 1 << 24,
         lookups: int = 1 << 22, reps: int = 5) -> list:
    """Run every case on ``device`` and print a line for each; returns one
    dict a case: {case, R, dtype, ms, bytes (table, indices and output,
    each once), lookups, clock}."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("profile_gather4: no CUDA device (--device cpu "
                           "runs the plain versions)")
    cuda = device.type == "cuda"
    clock = "device ms, CUDA events" if cuda else "host ms, cpu"
    name = torch.cuda.get_device_name(device) if cuda else "cpu"
    print(f"# gather probe on {name}: n={n} ni={ni} lookups={lookups} "
          f"reps={reps}", flush=True)
    g = torch.Generator(device=device).manual_seed(0)
    rows = []

    def randint(lo, hi, shape, dtype):
        return torch.randint(lo, hi, shape, dtype=dtype, generator=g,
                             device=device)

    idx = randint(0, n, (ni // 1024, 8, 128), torch.int32)
    for R, dtype in [(r, torch.int32) for r in ROW_WORDS] + \
            [(8, torch.int64)]:
        wide = dtype == torch.int64
        tab = randint(0, (1 << 63) - 1, (n, R), dtype) if wide else \
            randint(-(1 << 31), 1 << 31, (n, R), dtype)
        ms = time_ms(lambda: row_gather(tab, idx), reps, device)
        item = tab.element_size()
        nbytes = n * R * item + ni * 4 + ni * R * item
        label = f"R={R} u64" if wide else f"R={R:3d}"
        print(f"HBM row gather {label}: {ms:8.3f} ms ({clock}), "
              f"{nbytes / ms / 1e6:8.1f} GB/s", flush=True)
        rows.append({"case": "row gather", "R": R, "dtype": str(dtype),
                     "ms": ms, "bytes": nbytes, "lookups": ni,
                     "clock": clock})
        del tab
    del idx

    for R in DEPTHS:
        G = max(1, lookups // (R * COLS))
        tab = randint(0, 1 << 31, (G, R, COLS), torch.int32)
        idxs = randint(0, R, (G, R, COLS), torch.int32)
        ms = time_ms(lambda: dg3(tab, idxs), reps, device)
        tot = G * R * COLS
        print(f"dg3 dynamic_gather depth R={R:5d}: {ms:8.3f} ms ({clock}) "
              f"for {tot / 1e6:.1f} M lookups = {tot / ms / 1e3:8.1f} M/s",
              flush=True)
        rows.append({"case": "dg3", "R": R, "dtype": str(torch.int32),
                     "ms": ms, "bytes": 3 * 4 * tot, "lookups": tot,
                     "clock": clock})
        del tab, idxs
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser(
        prog="python -m panda_tpu_torch.tools.profile_gather4",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda:0",
                    help="cuda:<id> (the default) or cpu (plain versions)")
    main(torch.device(ap.parse_args().device))
