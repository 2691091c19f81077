"""Time the one-launch point Horner (``pt_ladder_horner``) at each group
size against the one-step route, at the three ceremony paths' shapes.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 -m dkg_tpu_torch.ops.horner_bench

It builds ``csrc/ladder_kernels.cu`` once per set of group sizes in
``VARIANTS`` (threads a lane on secp256k1, BLS12-381 G1 and
edwards25519, through ``-DDKG_TPI_SECP=...``; the first set is the
source's defaults), all builds in parallel, and makes each path's inputs
from a fixed numpy seed: T random coefficients below p in every
coordinate, shared by the lanes, and x = 1..n, as the batch verifier's
right side passes them (secp256k1 and BLS12-381 G1 T = 342, n = 1024,
nbits = 11; ristretto255 T = 86, n = 256, nbits = 9).  Per path and
group size it times REPS launches back to back behind a spin kernel by
CUDA events (device ms a launch), checks the output equals the default
build's limb for limb, and times the one-step route (T
``pt_ladder_mul_add`` launches) the same way.  It prints one JSON line:
the card, ptxas's lines per build, and per path the one-step ms and each
group size's ms.  Any output that differs raises.
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

from ..groups import device as gd
from . import build
from . import point_kernels as pk

# (curve, T, n)
PATHS = (("secp256k1", 342, 1024), ("bls12_381_g1", 342, 1024), ("ristretto255", 86, 256))
# threads a lane (secp256k1, BLS12-381 G1, edwards25519); BLS12-381 p's
# 12 words take 2, 3, 4, 6 or 12 (the group must divide a warp: 2 or 4)
VARIANTS = ((8, 4, 8), (4, 4, 4), (2, 2, 2))
REPS = 5
SOURCE = "ladder_kernels.cu"


def defines(v: tuple) -> tuple:
    return tuple(f"DKG_TPI_{c}={t}" for c, t in zip(("SECP", "BLS", "ED"), v))


def device_ms(fn, reps: int = REPS) -> float:
    """Device ms a call of ``fn``: a spin kernel holds the stream while the
    host enqueues the calls, so the events time their kernels back to back."""
    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(200_000_000)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def one_step(cs, coeffs, x, nbits):
    """The one-step route: T pt_ladder_mul_add launches."""
    acc = gd.identity(cs, x.shape, device=x.device)
    for l in reversed(range(coeffs.shape[0])):
        acc = pk.pt_ladder_mul_add(cs, acc, coeffs[l], x, nbits)
    return acc


def main() -> None:
    build.build((SOURCE, "point_kernels.cu", "bls_kernels.cu", "edwards_kernels.cu"),
                [(SOURCE, defines(v)) for v in VARIANTS[1:]])
    res = {"ptxas": {}}
    for v in VARIANTS:
        name = build.label(SOURCE, () if v == VARIANTS[0] else defines(v))
        res["ptxas"][str(v)] = [line.strip() for line in build.BUILD_LOGS.get(name, "").splitlines()
                                if "registers" in line or "spill" in line or "entry function" in line]
    rng = np.random.default_rng(11)
    for curve, T, n in PATHS:
        cs = gd.ALL_CURVES[curve]
        nbits = n.bit_length()
        limbs = rng.integers(0, 1 << 16, size=(T, cs.ncoords, cs.field.limbs))
        limbs[..., -1] %= cs.field.modulus >> (16 * (cs.field.limbs - 1))  # below p
        coeffs = torch.from_numpy(limbs.astype(np.int32)).cuda()
        x = torch.arange(1, n + 1, dtype=torch.int32, device="cuda")
        kernel = pk.kernel_for("pt_ladder_horner", cs)
        want = pk.pt_ladder_horner(cs, coeffs, x, nbits)
        row = {"T": T, "n": n, "one_step_ms": device_ms(lambda: one_step(cs, coeffs, x, nbits), reps=2)}
        if not torch.equal(one_step(cs, coeffs, x, nbits), want):
            raise RuntimeError(f"{curve}: pt_ladder_horner differs from the one-step route")
        for v in VARIANTS:
            k = kernel if v == VARIANTS[0] else kernel.variant(*defines(v))

            def call(k=k):
                out = torch.empty_like(want)
                k(coeffs.data_ptr(), 1, n, x.data_ptr(), out.data_ptr(), n, T, nbits,
                  build.stream_ptr(x.device))
                return out

            if not torch.equal(call(), want):
                raise RuntimeError(f"{curve}: the build with group sizes {v} differs from the default")
            row[f"tpi={v[[c for c, _, _ in PATHS].index(curve)]}"] = device_ms(call)
        res[curve] = row
    res["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                 capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
