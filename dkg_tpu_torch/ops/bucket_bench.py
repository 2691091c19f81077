"""Time ``bucket_accumulate`` alone at the point RLC's three path shapes.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 -m dkg_tpu_torch.ops.bucket_bench

It builds the two sources with bucket kernels (``csrc/bucket_kernels.cu``,
``csrc/bls_kernels.cu``), makes the scatter's inputs from a fixed numpy
seed (random limbs below p in every coordinate, and the digits of 128-bit
weights shared by every column, as the RLC passes them): secp256k1 342
columns of 1024 points at c = 8, ristretto255 86 columns of 256 at c = 4,
BLS12-381 G1 342 columns of 1024 at c = 8.  It times 5 wrapper calls
after one warm-up by CUDA events and prints one JSON line: the card,
ptxas's register and spill lines, and per path the ms and a digest of
the buckets.  To compare
two versions of the kernel, run it in both checkouts on the same card,
alternating (old, new, new, old): equal digests say the buckets are the
same bit for bit.
"""

from __future__ import annotations

import hashlib
import json
import subprocess

import numpy as np
import torch

from ..groups import device as gd
from . import bucket_kernels as bk
from . import build
from . import point_kernels as pk

# (curve, columns, m)
PATHS = (("secp256k1", 342, 1024), ("ristretto255", 86, 256), ("bls12_381_g1", 342, 1024))
SOURCES = ("bucket_kernels.cu", "bls_kernels.cu")
RHO_BITS = 128
REPS = 5


def scatter_inputs(rng, cs, cols: int, m: int):
    """(points (cols, m, C, L), shared digits (m, nw), window, nw)."""
    window = gd.pippenger_window(m, cs.name)
    nw = -(-RHO_BITS // window)
    limbs = rng.integers(0, 1 << 16, size=(cols, m, cs.ncoords, cs.field.limbs))
    limbs[..., -1] %= cs.field.modulus >> (16 * (cs.field.limbs - 1))  # below p
    rho = rng.integers(0, 1 << 16, size=(m, cs.scalar.limbs))
    rho[:, RHO_BITS // 16:] = 0
    pts = torch.from_numpy(limbs.astype(np.int32)).cuda()
    digits = pk.window_digits(torch.from_numpy(rho.astype(np.int32)).cuda(), window)[:, :nw].contiguous()
    return pts, digits, window, nw


def main() -> None:
    build.build(SOURCES)
    log = "\n".join(build.BUILD_LOGS.get(src, "") for src in SOURCES)
    res = {"ptxas": [line.strip() for line in log.splitlines() if "registers" in line or "spill" in line]}
    rng = np.random.default_rng(7)
    for curve, cols, m in PATHS:
        cs = gd.ALL_CURVES[curve]
        pts, digits, window, nw = scatter_inputs(rng, cs, cols, m)
        bk.bucket_accumulate(cs, pts, digits, window, nw)
        torch.cuda.synchronize()
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            out = bk.bucket_accumulate(cs, pts, digits, window, nw)
        end.record()
        end.synchronize()
        res[curve] = {"shape": list(out.shape), "ms": start.elapsed_time(end) / REPS,
                      "digest": hashlib.sha256(out.cpu().numpy().tobytes()).hexdigest()[:16]}
    res["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                 capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
