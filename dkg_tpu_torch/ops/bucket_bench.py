"""Time Pippenger's scatter and bucket close at the point RLC's three path
shapes: ``bucket_accumulate`` and the 2 (2**c - 1) ``pt_add`` launches of
the close, against ``pt_bucket_sum`` (one thread a lane) and
``pt_bucket_close`` in each build: the source's settings (a group of 4
threads a lane on secp256k1 and BLS12-381, one thread on ristretto255),
one thread, and other group sizes.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 -m dkg_tpu_torch.ops.bucket_bench [--scale]

``--scale`` times only ``pt_bucket_close`` at BLS12-381 G1's n = 16384
RLC (5462 columns x 16 windows = 87,392 lanes, random buckets on the
card), the default build against the one-thread build, both held to the
pt_add route.  Without it, it builds the sources with bucket and point kernels, and
``csrc/pippenger_kernels.cu`` once per entry of ``VARIANTS`` (the close's
other group sizes, 1 for one thread a lane, through
``-DDKG_BUCKET_TPI_SECP=...`` / ``_BLS``; the first entry is the source's
defaults), all in parallel, and makes the scatter's
inputs from a fixed numpy seed (random limbs below p in every coordinate,
and the digits of 128-bit weights shared by every column, as the RLC
passes them): secp256k1 342 columns of 1024 points at c = 8,
ristretto255 86 columns of 256 at c = 4, BLS12-381 G1 342 columns of
1024 at c = 8, the points held (m, B) as the ceremony holds them.  In
every build, on the curves it sets, both new kernels are first held
against their plain versions at small edges (a
bucket holding every point, all digits zero, 33 columns), then at the
path's shape against the old route: the sum equal to bucket_accumulate's
buckets from 1 on, the close to the pt_add launches'.  Each is timed REPS
calls back to back behind a spin kernel by CUDA events (device ms a call).
It prints ptxas's lines per build and one JSON line: the card, and per
path the old route's ms, each build's ms, and a digest of the
old scatter's buckets (run it in two checkouts on one card, in turns, to
A/B a change: equal digests say the buckets are the same bit for bit).
Any output that differs raises.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import subprocess
import sys

import numpy as np
import torch

from ..groups import device as gd
from . import bucket_kernels as bk
from . import build
from . import point_kernels as pk
from .chain_bench import device_ms

# (curve, columns, m)
PATHS = (("secp256k1", 342, 1024), ("ristretto255", 86, 256), ("bls12_381_g1", 342, 1024))
SOURCES = ("bucket_kernels.cu", "bls_kernels.cu", "point_kernels.cu", "edwards_kernels.cu")
NEW_SOURCE = "pippenger_kernels.cu"
CURVES = tuple(c for c, _, _ in PATHS)
# (label, extra defines, the curves whose close the build sets: ristretto255's
# is one thread a lane in every build)
VARIANTS = (
    ("default", (), CURVES),
    ("one thread", ("DKG_BUCKET_TPI_SECP=1", "DKG_BUCKET_TPI_BLS=1"), ("secp256k1", "bls12_381_g1")),
    ("groups of 8", ("DKG_BUCKET_TPI_SECP=8",), ("secp256k1",)),
    ("groups of 2", ("DKG_BUCKET_TPI_SECP=2", "DKG_BUCKET_TPI_BLS=2"), ("secp256k1", "bls12_381_g1")),
)
RHO_BITS = 128
REPS = 5


def scatter_inputs(rng, cs, cols: int, m: int):
    """(points (cols, m, C, L), a view of (m, cols) storage; shared digits
    (m, nw); window; nw)."""
    window = gd.pippenger_window(m, cs.name)
    nw = -(-RHO_BITS // window)
    limbs = rng.integers(0, 1 << 16, size=(m, cols, cs.ncoords, cs.field.limbs))
    limbs[..., -1] %= cs.field.modulus >> (16 * (cs.field.limbs - 1))  # below p
    rho = rng.integers(0, 1 << 16, size=(m, cs.scalar.limbs))
    rho[:, RHO_BITS // 16:] = 0
    pts = torch.from_numpy(limbs.astype(np.int32)).cuda().movedim(0, 1)
    digits = pk.window_digits(torch.from_numpy(rho.astype(np.int32)).cuda(), window)[:, :nw].contiguous()
    return pts, digits, window, nw


def close_route(cs, buckets: torch.Tensor) -> torch.Tensor:
    """The close as 2 (2**c - 1) pt_add launches (the port's before)."""
    run = tot = gd.identity(cs, buckets.shape[:-3], device=buckets.device)
    for e in reversed(range(buckets.shape[-3])):
        run = pk.pt_add(cs, run, buckets[..., e, :, :])
        tot = pk.pt_add(cs, tot, run)
    return tot


@contextlib.contextmanager
def forced(cs, kernels: tuple):
    """pt_bucket_sum and pt_bucket_close on ``cs`` through ``kernels`` (a
    build's)."""
    key = (cs.kind, cs.field.name, cs.const)
    saved = (bk._SUM_VARIANTS[key], bk._CLOSE_VARIANTS[key])
    bk._SUM_VARIANTS[key], bk._CLOSE_VARIANTS[key] = kernels
    try:
        yield
    finally:
        bk._SUM_VARIANTS[key], bk._CLOSE_VARIANTS[key] = saved


def edges(rng, cs, device) -> list:
    """(label, points (B, m, C, L), digits (m, nw), window) at the edges."""
    def pts(b, m):
        limbs = rng.integers(0, 1 << 16, size=(b, m, cs.ncoords, cs.field.limbs))
        limbs[..., -1] %= cs.field.modulus >> (16 * (cs.field.limbs - 1))
        return torch.from_numpy(limbs.astype(np.int32)).to(device)
    one = torch.full((9, 2), 3, dtype=torch.int32, device=device)
    return [("a bucket holding every point, 33 columns", pts(33, 9), one, 4),
            ("all digits zero", pts(5, 9), torch.zeros_like(one), 4),
            ("random digits at c = 8", pts(3, 9), torch.from_numpy(rng.integers(0, 256, size=(9, 2)).astype(
                np.int32)).to(device), 8)]


# the close's (column, window) lanes at BASELINE.md config 5 (BLS12-381 G1,
# n = 16384, t = 5461: 5462 columns, 16 windows of c = 8), past 2**15
SCALE = ("bls12_381_g1", 5462, 16384)


def close_at_scale() -> dict:
    """``pt_bucket_close`` at SCALE's lanes, random buckets made on the card
    from a fixed seed: the default build (a group of 4 threads a lane) and
    the one-thread build, each held to the 2 (2**c - 1) pt_add launches and
    timed REPS calls behind a spin kernel (device ms a call)."""
    curve, cols, m = SCALE
    cs = gd.ALL_CURVES[curve]
    window = gd.pippenger_window(m, curve)
    nw, nb = -(-RHO_BITS // window), (1 << window) - 1
    gen = torch.Generator(device="cuda").manual_seed(7)
    buckets = torch.randint(0, 1 << 16, (cols, nw, nb, cs.ncoords, cs.field.limbs), generator=gen,
                            device="cuda", dtype=torch.int32)
    buckets[..., -1] %= cs.field.modulus >> (16 * (cs.field.limbs - 1))  # below p
    want = close_route(cs, buckets)
    row = {"lanes": cols * nw, "close_route_ms": device_ms(lambda: close_route(cs, buckets), reps=1,
                                                           spin=800_000_000)}
    base = (bk.sum_kernel_for(cs), bk.close_kernel_for(cs))
    for label, defines, curves in VARIANTS[:2]:
        kernels = tuple(k.variant(*defines) if defines else k for k in base)
        with forced(cs, kernels):
            if not torch.equal(bk.pt_bucket_close(cs, buckets), want):
                raise RuntimeError(f"pt_bucket_close {curve} {label}: differs from the pt_add route at scale")
            row[f"close {label}"] = device_ms(lambda: bk.pt_bucket_close(cs, buckets))
    return row


def main() -> None:
    if "--scale" in sys.argv[1:]:
        build.build(SOURCES + (NEW_SOURCE,), variants=[(NEW_SOURCE, tuple(VARIANTS[1][1]))])
        res = {f"{SCALE[0]} close at scale": close_at_scale()}
        res["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                     capture_output=True, text=True, check=True, timeout=60).stdout.strip()
        print(json.dumps(res), flush=True)
        return
    variants = [(NEW_SOURCE, tuple(d)) for _, d, _ in VARIANTS if d]
    build.build(SOURCES + (NEW_SOURCE,), variants=variants)
    res = {"ptxas": {}}
    for label, defines, _ in VARIANTS:
        log = build.BUILD_LOGS.get(build.label(NEW_SOURCE, defines), "")
        res["ptxas"][label] = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
    rng = np.random.default_rng(7)
    held = 0
    for curve, cols, m in PATHS:
        cs = gd.ALL_CURVES[curve]
        pts, digits, window, nw = scatter_inputs(rng, cs, cols, m)
        old = bk.bucket_accumulate(cs, pts, digits, window, nw)
        buckets = old[..., 1:, :, :]
        tot = close_route(cs, buckets)
        row = {"shape": list(old.shape), "digest": hashlib.sha256(old.cpu().numpy().tobytes()).hexdigest()[:16],
               "bucket_accumulate_ms": device_ms(lambda: bk.bucket_accumulate(cs, pts, digits, window, nw)),
               "close_route_ms": device_ms(lambda: close_route(cs, buckets), reps=1, spin=800_000_000)}
        base = (bk.sum_kernel_for(cs), bk.close_kernel_for(cs))
        for label, defines, curves in VARIANTS:
            if curve not in curves:
                continue
            kernels = tuple(k.variant(*defines) if defines else k for k in base)
            with forced(cs, kernels):
                for what, p, d, w in edges(rng, cs, "cuda"):
                    got = bk.pt_bucket_sum(cs, p, d, w)
                    want = bk.pt_bucket_sum_plain(cs, p.cpu(), *bk.bucket_lists(d.cpu(), w))
                    if not torch.equal(got.cpu(), want):
                        raise RuntimeError(f"pt_bucket_sum {curve} {label}: {what} differs")
                    if not torch.equal(bk.pt_bucket_close(cs, got).cpu(), bk.pt_bucket_close_plain(cs, want)):
                        raise RuntimeError(f"pt_bucket_close {curve} {label}: {what} differs")
                    held += 2
                got = bk.pt_bucket_sum(cs, pts, digits, window)
                if not torch.equal(got, buckets):
                    raise RuntimeError(f"pt_bucket_sum {curve} {label}: differs from bucket_accumulate")
                if not torch.equal(bk.pt_bucket_close(cs, got), tot):
                    raise RuntimeError(f"pt_bucket_close {curve} {label}: differs from the pt_add route")
                row[f"sum {label}"] = device_ms(lambda: bk.pt_bucket_sum(cs, pts, digits, window))
                row[f"close {label}"] = device_ms(lambda: bk.pt_bucket_close(cs, got))
        res[curve] = row
        print(f"{curve}: " + json.dumps(row), flush=True)
    print(f"edges held: {held} calls", flush=True)
    res["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                 capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    main()
