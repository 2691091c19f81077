"""Time ``mod_batch_inv`` (a whole Montgomery-trick batch inversion in one
launch) at each row count of ``ROWS`` against its one-step route, at the
shapes ``groups.device.affine_canon`` gives it, and hold it at the edges;
with ``--gemm``, the same for ``mxu_batch_inv`` (every multiply the fused
multiply-reduce with its fold on the tensor cores), with the one-step
``mxu_mod_mul`` timed beside it.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 -m dkg_tpu_torch.ops.inv_bench [--gemm]

For each base field it inverts the lanes of each shape of ``SHAPES``
(non-zero random elements from a fixed numpy seed) as ``affine_canon``
lays them out, (k, lanes / k, L) for k in ``ROWS``: the commitments of a
ceremony's canonical affine form (n (t+1) lanes), the unchunked seal's
KEM points (n**2) and a default chunk's (4096).  Each call is timed five
times back to back behind a spin kernel by CUDA events (device ms a call)
and its output, lane by lane, held equal to the one-step route's: the
JAX package's shape, 256 rows, each multiply of ``fields.device.batch_inv``
one ``mod_mul`` launch (timed the same way, with its launches counted).
First every field is held against the plain version (``batch_inv`` with
the plain multiply, on the CPU) at the edges: 1 and p - 1, a column of
one repeated element, a column holding a zero (which reads 0), k = 1, and
k = 256, 64 and 16 over a few columns.  It prints ptxas's lines and one
JSON line: the card, and per field and shape the route's ms and launches
and each row count's ms.  Any output that differs raises.

``--gemm`` does the same for ``mxu_batch_inv`` at ``GEMM_ROWS`` and the
canonical form's shape alone (the only call ``mul="gemm"`` makes), against its route, the
256-row chain of ``mxu_mod_mul`` launches, and at the edges against its
plain version (``batch_inv`` with ``_mul_gemm``, on the CPU), with a
column count that is not a multiple of a warp's 32; and times the one-step
``mxu_mod_mul`` at the canonical form's x·zi lanes and a 256-row chain
step's.
"""

from __future__ import annotations

import json
import subprocess

import numpy as np
import torch

from ..fields import device as fd
from ..fields import host as fh
from ..fields.spec import BLS12_381_P, P25519, SECP256K1_P
from . import build
from . import field_kernels as fk
from . import mxu_kernels as mk
from .chain_bench import device_ms, rand_below

ROWS = (256, 64, 16)
GEMM_ROWS = (64, 16, 8, 4)  # mxu_batch_inv's: a warp-wide multiply wants more columns in flight
ROUTE_ROWS = 256  # the JAX package's affine_canon
# field -> the shapes' lane counts: (label, lanes)
SHAPES = {
    SECP256K1_P: (("canon n=1024", 1024 * 342), ("seal unchunked", 1024 * 1024), ("seal chunk", 4096)),
    P25519: (("canon n=256", 256 * 86), ("seal unchunked", 256 * 256), ("seal chunk", 4096)),
    BLS12_381_P: (("canon n=1024", 1024 * 342), ("seal unchunked", 1024 * 1024), ("seal chunk", 4096)),
}
SOURCES = ("inv_kernels.cu", "field_kernels.cu")


def nonzero(rng, fs, lanes: int, device) -> torch.Tensor:
    """Random non-zero elements (lanes, L) below the modulus's top limb."""
    x = rand_below(rng, fs.modulus, fs.limbs, (lanes,), device)
    x[:, 0] |= 1
    return x


def route(fs, flat: torch.Tensor, mul=fk.mod_mul) -> torch.Tensor:
    """The one-step route: the JAX package's 256 rows, each multiply one
    launch of ``mul``."""
    return fd.batch_inv(fs, flat.reshape(ROUTE_ROWS, -1, fs.limbs), mul=mul).reshape(flat.shape)


def edges(rng, fs, device) -> list:
    """(label, x (k, cols, L)) at the edges."""
    p = fs.modulus
    ends = fh.to_tensor(fh.encode(fs, [1, p - 1, 1, p - 1, 2, p - 2]), device).reshape(6, 1, fs.limbs)
    cols = nonzero(rng, fs, 16 * 5, device).reshape(16, 5, fs.limbs)
    cols[:, 1] = cols[0, 1]  # a column of one repeated element
    cols[3, 2] = 0  # a column holding a zero
    cols[:, 4] = ends.reshape(6, fs.limbs).repeat(3, 1)[:16]
    out = [("1, p - 1, 2 and p - 2 down one column", ends), ("repeated element, zero, ends", cols),
           ("k = 1", nonzero(rng, fs, 7, device).reshape(1, 7, fs.limbs))]
    for k in ROWS:
        out.append((f"k = {k}", nonzero(rng, fs, k * 3, device).reshape(k, 3, fs.limbs)))
    return out


def gemm_main() -> None:
    """mxu_batch_inv's row counts, and the one-step mxu_mod_mul (``--gemm``)."""
    build.build(("mxu_kernels.cu",))
    for line in build.BUILD_LOGS.get("mxu_kernels.cu", "").splitlines():
        if "registers" in line or "spill" in line or "entry function" in line or "stack frame" in line:
            print(f"ptxas mxu_kernels.cu: {line.strip()}", flush=True)
    rng = np.random.default_rng(10)
    res, held = {}, 0
    for fs, shapes in SHAPES.items():
        kernel, mul = mk.batch_inv_kernel_for(fs), mk.kernel_for(fs)
        for label, x in edges(rng, fs, "cuda") + [("k = 16, 40 columns", nonzero(rng, fs, 640, "cuda").reshape(
                16, 40, fs.limbs))]:
            if not torch.equal(mk.mxu_batch_inv(fs, x).cpu(), mk.mxu_batch_inv_plain(fs, x.cpu())):
                raise RuntimeError(f"{kernel.name}: {label} differs from the plain version")
            held += 1
        label, lanes = shapes[0]
        flat = nonzero(rng, fs, lanes, "cuda")
        mul.launches = 0
        want = route(fs, flat, mk.mxu_mod_mul)
        row = {"lanes": lanes, "one_step_launches": mul.launches,
               "one_step_ms": device_ms(lambda: route(fs, flat, mk.mxu_mod_mul), reps=1, spin=800_000_000)}
        for k in GEMM_ROWS:
            x = flat.reshape(k, -1, fs.limbs)
            if not torch.equal(mk.mxu_batch_inv(fs, x).reshape(flat.shape), want):
                raise RuntimeError(f"{kernel.name} {label} k={k}: differs from the one-step route")
            row[f"k={k}"] = device_ms(lambda x=x: mk.mxu_batch_inv(fs, x))
        for what, n in (("x·zi", lanes), ("a 256-row step", lanes // ROUTE_ROWS)):
            a, b = nonzero(rng, fs, n, "cuda"), nonzero(rng, fs, n, "cuda")
            row[f"mxu_mod_mul {what}"] = device_ms(lambda a=a, b=b: mk.mxu_mod_mul(fs, a, b))
        res[f"{kernel.name} {label}"] = row
        print(f"{kernel.name} {label}: " + json.dumps(row), flush=True)
    print(f"edges held: {held} calls", flush=True)
    res["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                 capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps(res), flush=True)


def main() -> None:
    build.build(SOURCES)
    for line in build.BUILD_LOGS.get("inv_kernels.cu", "").splitlines():
        if "registers" in line or "spill" in line or "entry function" in line or "stack frame" in line:
            print(f"ptxas inv_kernels.cu: {line.strip()}", flush=True)
    rng = np.random.default_rng(9)
    res, held = {}, 0
    for fs, shapes in SHAPES.items():
        kernel = fk.batch_inv_kernel_for(fs)
        for label, x in edges(rng, fs, "cuda"):
            got = fk.mod_batch_inv(fs, x).cpu()
            if not torch.equal(got, fd.batch_inv(fs, x.cpu())):
                raise RuntimeError(f"{kernel.name}: {label} differs from the plain version")
            held += 1
        for label, lanes in shapes:
            flat = nonzero(rng, fs, lanes, "cuda")
            fk.mul_kernel_for(fs).launches = 0
            want = route(fs, flat)
            row = {"lanes": lanes, "one_step_launches": fk.mul_kernel_for(fs).launches,
                   "one_step_ms": device_ms(lambda: route(fs, flat), reps=1, spin=800_000_000)}
            for k in ROWS:
                x = flat.reshape(k, -1, fs.limbs)
                if not torch.equal(fk.mod_batch_inv(fs, x).reshape(flat.shape), want):
                    raise RuntimeError(f"{kernel.name} {label} k={k}: differs from the one-step route")
                row[f"k={k}"] = device_ms(lambda x=x: fk.mod_batch_inv(fs, x))
            res[f"{kernel.name} {label}"] = row
            print(f"{kernel.name} {label}: " + json.dumps(row), flush=True)
    print(f"edges held: {held} calls (1 and p - 1, a repeated element, a zero column, k = 1, k in {ROWS})",
          flush=True)
    res["card"] = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                                 capture_output=True, text=True, check=True, timeout=60).stdout.strip()
    print(json.dumps(res), flush=True)


if __name__ == "__main__":
    import sys

    if "--gemm" in sys.argv[1:]:
        gemm_main()
    else:
        main()
