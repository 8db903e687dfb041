"""The rate of field.cuh's two Montgomery multiplies on the card.

    python -m panda_tpu_torch.tools.mul_rate

Builds ``csrc/mul_rate.cu`` and, for each NTT scalar field, runs chains of
dependent products with ``mont_mul`` (separate lo and hi carry chains) and
``mont_mul_wide`` (each word product's halves adjacent in one chain), at 2,
4 and 8 blocks of 256 threads an SM: one JSON line a case with the device
ms (CUDA events around one launch after a warm-up), the products a second
and their share of the 16.7 T/s multiply-add peak at 264 a product.  The
two variants' final words must be equal.  Raises without a GPU.
"""

from __future__ import annotations

import json

import torch

from ..ops import _ext
from ..ops._ext import I32, P
from .bounds import IMAD_PER_S, MONT_MUL_IMADS

THREADS = 256
ITERS = 1024
ILP = 2                      # csrc/mul_rate.cu's kMulRateIlp
PEAK_PRODUCTS_PER_S = IMAD_PER_S / MONT_MUL_IMADS


def main(device=None) -> list:
    if not torch.cuda.is_available():
        raise RuntimeError("mul_rate: no CUDA device")
    device = torch.device(device or "cuda:0")
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    f = _ext._fn("mul_rate", "ptt_mul_rate", [P, I32, I32, I32, I32, I32, P])
    rows = []
    for field, name in enumerate(_ext.NTT_FIELDS):
        for per_sm in (2, 4, 8):
            blocks = sms * per_sm
            outs = {}
            for wide in (0, 1):
                out = torch.empty((ILP, 8, blocks * THREADS),
                                  dtype=torch.int32, device=device)

                def run():
                    with torch.cuda.device(device):
                        rc = f(out.data_ptr(), blocks, THREADS, ITERS, field,
                               wide, torch.cuda.current_stream().cuda_stream)
                    _ext._check("mul_rate", "ptt_mul_rate", rc)
                run()
                a, b = (torch.cuda.Event(enable_timing=True)
                        for _ in range(2))
                torch.cuda.synchronize(device)
                a.record()
                run()
                b.record()
                torch.cuda.synchronize(device)
                ms = a.elapsed_time(b)
                rate = blocks * THREADS * ITERS * ILP / ms * 1e3
                outs[wide] = out
                row = {"field": name, "multiply": ("mont_mul_wide" if wide
                                                   else "mont_mul"),
                       "blocks_an_sm": per_sm, "ms": ms,
                       "products_per_s": rate,
                       "share_of_peak": rate / PEAK_PRODUCTS_PER_S}
                print(json.dumps(row), flush=True)
                rows.append(row)
            if not torch.equal(outs[0], outs[1]):
                raise AssertionError(f"mul_rate ({name}): mont_mul_wide's "
                                     "products differ from mont_mul's")
    return rows


if __name__ == "__main__":
    print(f"[mul_rate] {torch.cuda.get_device_name(0)}"
          if torch.cuda.is_available() else "", flush=True)
    main()
