"""Time the plain field ops of ``fields/device.py`` at a small batch.

Run from the root of a checkout:

    python3 -m dkg_tpu_torch.fields.mul_bench [--lanes 4] [--reps 200] [--threads 1]

The plain versions run wherever the CPU tests run a kernel's wrapper, so
at the tests' small batches their cost is the number of PyTorch ops they
dispatch.  For each field of the three curves' base fields it makes
``--lanes`` random elements from a fixed seed and prints one JSON line:
the ms per call of ``mul``, ``add`` and ``sub`` over ``--reps`` calls
after a warm-up, on the CPU with ``--threads`` threads, and the
top-level ATen ops of one warm ``mul`` (torch.profiler).  It measures the host's
CPU, never a device.  To compare two versions, run it in both checkouts
in turns (old, new, new, old, ...) and compare medians.
"""

from __future__ import annotations

import argparse
import json
import random
import time

import torch

from . import device as fd
from . import host as fh
from .spec import ALL_FIELDS

FIELDS = ("secp256k1_base", "ed25519_base", "bls12_381_base")


def aten_ops(fn) -> int:
    """Top-level ATen ops one call of ``fn`` dispatches."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return sum(1 for e in prof.events() if e.name.startswith("aten::") and e.cpu_parent is None)


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--lanes", type=int, default=4)
    ap.add_argument("--reps", type=int, default=200)
    ap.add_argument("--threads", type=int, default=1)
    args = ap.parse_args()
    torch.set_num_threads(args.threads)
    rng = random.Random(1)
    out = {"device": "cpu", "threads": args.threads, "lanes": args.lanes}
    for name in FIELDS:
        fs = ALL_FIELDS[name]
        a = fh.to_tensor(fh.encode(fs, [rng.randrange(fs.modulus) for _ in range(args.lanes)]), "cpu")
        b = a.flip(0)
        row = {}
        for op in ("mul", "add", "sub"):
            fn = getattr(fd, op)
            for _ in range(5):
                fn(fs, a, b)
            t0 = time.perf_counter()
            for _ in range(args.reps):
                fn(fs, a, b)
            row[f"{op}_ms"] = 1e3 * (time.perf_counter() - t0) / args.reps
        row["mul_aten_ops"] = aten_ops(lambda: fd.mul(fs, a, b))
        out[name] = row
    print(json.dumps(out))


if __name__ == "__main__":
    main()
