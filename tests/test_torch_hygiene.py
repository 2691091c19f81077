"""The port stands alone: importing dkg_tpu_torch (every module) and
chip_smoke.py pulls in neither jax nor dkg_tpu, and on anything but a CPU
tensor a kernel wrapper launches its kernel or raises, never falling back
to its plain version."""

import dataclasses
import inspect
import pathlib
import random
import re
import subprocess
import sys

import pytest
import torch

from dkg_tpu_torch import sign as ts
from dkg_tpu_torch.crypto import elgamal as tel
from dkg_tpu_torch.dkg import ceremony as tce
from dkg_tpu_torch.dkg import committee as tcm
from dkg_tpu_torch.dkg import committee_batch as tcmb
from dkg_tpu_torch.dkg import complaints_batch as tcb
from dkg_tpu_torch.dkg import procedure_keys as tpk
from dkg_tpu_torch.epoch import dealing as tdl
from dkg_tpu_torch.epoch import inprocess as tinp
from dkg_tpu_torch.dkg import hybrid_batch as hb
from dkg_tpu_torch.fields.spec import BLS12_381_P, BLS12_381_R, L25519, P25519, SECP256K1_N, SECP256K1_P, FieldSpec
from dkg_tpu_torch.groups import device as tgd
from dkg_tpu_torch.groups import host as tgh
from dkg_tpu_torch.groups import ristretto_device as trd
from dkg_tpu_torch.ops import bucket_kernels as bk
from dkg_tpu_torch.ops import build
from dkg_tpu_torch.ops import field_kernels as fk
from dkg_tpu_torch.ops import mxu_kernels as mk
from dkg_tpu_torch.ops import point_kernels as pk
from dkg_tpu_torch.poly import device as tpd
from dkg_tpu_torch.service import engine as tsvc_engine
from torch_port_util import one_thread  # noqa: F401  (one intra-op thread for this module)

REPO = pathlib.Path(__file__).resolve().parent.parent
PORT = REPO / "dkg_tpu_torch"


def _modules():
    return sorted(
        ".".join(p.relative_to(REPO).with_suffix("").parts).removesuffix(".__init__")
        for p in PORT.rglob("*.py")
    )


def test_port_imports_neither_jax_nor_the_jax_package():
    assert {"dkg_tpu_torch.dkg.hybrid_batch", "dkg_tpu_torch.crypto.chacha", "dkg_tpu_torch.crypto.blake2",
            "dkg_tpu_torch.crypto.elgamal", "dkg_tpu_torch.crypto.dleq_batch", "dkg_tpu_torch.poly.host",
            "dkg_tpu_torch.sign.verify", "dkg_tpu_torch.crypto.commitment", "dkg_tpu_torch.crypto.correct_decryption",
            "dkg_tpu_torch.dkg.errors", "dkg_tpu_torch.dkg.procedure_keys", "dkg_tpu_torch.dkg.broadcast",
            "dkg_tpu_torch.dkg.committee", "dkg_tpu_torch.dkg.committee_batch", "dkg_tpu_torch.dkg.complaints_batch",
            "dkg_tpu_torch.dkg.storm_bench", "dkg_tpu_torch.utils.tracing", "dkg_tpu_torch.groups.ristretto_device",
            "dkg_tpu_torch.utils.serde", "dkg_tpu_torch.utils.envknobs", "dkg_tpu_torch.utils.metrics",
            "dkg_tpu_torch.net", "dkg_tpu_torch.net.channel", "dkg_tpu_torch.net.checkpoint", "dkg_tpu_torch.epoch",
            "dkg_tpu_torch.epoch.errors", "dkg_tpu_torch.epoch.state", "dkg_tpu_torch.epoch.messages",
            "dkg_tpu_torch.epoch.dealing", "dkg_tpu_torch.epoch.inprocess",
            "dkg_tpu_torch.epoch.manager", "dkg_tpu_torch.utils.obslog", "dkg_tpu_torch.service",
            "dkg_tpu_torch.service.buckets", "dkg_tpu_torch.service.engine", "dkg_tpu_torch.service.durable",
            "dkg_tpu_torch.service.errors", "dkg_tpu_torch.service.slo", "dkg_tpu_torch.service.httpobs",
            "dkg_tpu_torch.service.faultsvc", "dkg_tpu_torch.service.scheduler", "dkg_tpu_torch.net.party",
            "dkg_tpu_torch.net.faults", "dkg_tpu_torch.groups.precompute", "dkg_tpu_torch.groups.device",
            "dkg_tpu_torch.native", "dkg_tpu_torch.parallel", "dkg_tpu_torch.parallel.mesh",
            "dkg_tpu_torch.parallel.hostmesh", "dkg_tpu_torch.parallel.multihost",
            "dkg_tpu_torch.parallel.signmesh"} <= set(_modules())
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r} + ['chip_smoke']:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'dkg_tpu'))\n"
        "print('BAD', bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


@pytest.mark.parametrize("module", ["dkg_tpu_torch.utils.scanchunk", "dkg_tpu_torch.fields.matmul",
                                    "dkg_tpu_torch.native", "dkg_tpu_torch.parallel.mesh",
                                    "dkg_tpu_torch.parallel.hostmesh", "dkg_tpu_torch.parallel.multihost",
                                    "dkg_tpu_torch.parallel.signmesh"])
def test_scale_modules_stand_alone(module):
    """The memory-bounded layer's modules (map_chunked; matmul_mod and its
    routes), the native runtime and the party mesh are among those the
    whole-port import check loads, and alone pull in neither jax nor
    dkg_tpu."""
    assert module in _modules()
    code = (f"import importlib, sys\nimportlib.import_module({module!r})\n"
            "sys.exit(1 if [m for m in sys.modules if m.split('.')[0] in ('jax', 'jaxlib', 'dkg_tpu')] else 0)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stdout + proc.stderr


def test_no_source_line_imports_jax_or_the_jax_package():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|dkg_tpu)(\.|\s|$)")
    files = [*PORT.rglob("*.py"), REPO / "chip_smoke.py"]
    hits = [f"{f}:{i}" for f in files for i, line in enumerate(f.read_text().splitlines(), 1)
            if pattern.match(line)]
    assert hits == []


def _meta(shape):
    return torch.zeros(shape, dtype=torch.int32, device="meta")


ED, BLS = tgd.RISTRETTO255, tgd.BLS12_381_G1
KERNELS = (*fk.KERNELS, *pk.KERNELS, *bk.KERNELS, *mk.KERNELS)
# 24-limb curves with no kernel: BLS12-381 G1 with another b3, and a curve
# over another 24-limb field (a 381-bit modulus other than BLS12-381 p)
OTHER_P = (1 << 381) - 1287
L24_B3 = dataclasses.replace(BLS, name="other_b3", const=24)
L24_P = dataclasses.replace(BLS, name="other_p", field=FieldSpec("other_base", OTHER_P, 24))


@pytest.mark.parametrize("call", [
    lambda: fk.mod_madd(SECP256K1_N, _meta((4, 16)), _meta((4, 16)), _meta((4, 16))),
    lambda: pk.pt_add(tgd.SECP256K1, _meta((4, 3, 16)), _meta((4, 3, 16))),
    lambda: pk.pt_madd(tgd.SECP256K1, _meta((4, 3, 16)), _meta((4, 3, 16))),
    lambda: pk.pt_window_step(tgd.SECP256K1, _meta((4, 3, 16)), _meta((4, 3, 16)), 4),
    lambda: pk.pt_ladder_mul_add(tgd.SECP256K1, _meta((4, 3, 16)), _meta((4, 3, 16)), _meta((4,)), 3),
    lambda: fk.mod_madd(L25519, _meta((4, 16)), _meta((4, 16)), _meta((4, 16))),
    lambda: pk.pt_add(ED, _meta((4, 4, 16)), _meta((4, 4, 16))),
    lambda: pk.pt_madd(ED, _meta((4, 4, 16)), _meta((4, 4, 16))),
    lambda: pk.pt_double(ED, _meta((4, 4, 16)), 4),
    lambda: pk.pt_double(tgd.SECP256K1, _meta((4, 3, 16)), 1),
    lambda: pk.pt_ladder_mul_add(ED, _meta((4, 4, 16)), _meta((4, 4, 16)), _meta((4,)), 3),
    lambda: tgd.window_step(ED, _meta((4, 4, 16)), _meta((4, 4, 16)), 4),
    lambda: bk.bucket_accumulate(tgd.SECP256K1, _meta((2, 5, 3, 16)), _meta((5, 3)), 8, 3),
    lambda: bk.bucket_accumulate(ED, _meta((2, 5, 4, 16)), _meta((2, 5, 3)), 4, 3),
    lambda: tgd.msm_pippenger(ED, _meta((5, 16)), _meta((2, 5, 4, 16)), 128),
    lambda: fk.mod_madd(BLS12_381_P, _meta((4, 24)), _meta((4, 24)), _meta((4, 24))),
    lambda: fk.mod_madd(BLS12_381_R, _meta((4, 16)), _meta((4, 16)), _meta((4, 16))),
    lambda: pk.pt_add(BLS, _meta((4, 3, 24)), _meta((4, 3, 24))),
    lambda: pk.pt_madd(BLS, _meta((4, 3, 24)), _meta((4, 3, 24))),
    lambda: pk.pt_double(BLS, _meta((4, 3, 24)), 4),
    lambda: pk.pt_window_step(BLS, _meta((4, 3, 24)), _meta((4, 3, 24)), 4),
    lambda: pk.pt_ladder_mul_add(BLS, _meta((4, 3, 24)), _meta((4, 3, 24)), _meta((4,)), 3),
    lambda: bk.bucket_accumulate(BLS, _meta((2, 5, 3, 24)), _meta((5, 3)), 8, 3),
    lambda: tgd.msm_pippenger(BLS, _meta((5, 16)), _meta((2, 5, 3, 24)), 128),
    lambda: fk.mod_mul(SECP256K1_N, _meta((4, 16)), _meta((4, 16))),
    lambda: fk.mod_mul(P25519, _meta((4, 16)), _meta((4, 16))),
    lambda: fk.mod_mul(BLS12_381_P, _meta((4, 24)), _meta((4, 24))),
    lambda: mk.mxu_mod_mul(SECP256K1_N, _meta((4, 16)), _meta((4, 16))),
    lambda: mk.mxu_mod_mul(P25519, _meta((4, 16)), _meta((4, 16))),
    lambda: mk.mxu_mod_mul(BLS12_381_P, _meta((4, 24)), _meta((4, 24))),
    lambda: tgd.affine_canon(BLS, _meta((2, 3, 24))),
    lambda: tgd.affine_canon(ED, _meta((2, 4, 16)), mul="gemm"),
    lambda: pk.pt_window_step(ED, _meta((4, 4, 16)), _meta((4, 4, 16)), 8),
    lambda: tgd.scalar_mul(ED, _meta((3, 16)), _meta((3, 4, 16))),
    lambda: tgd.scalar_mul(tgd.SECP256K1, _meta((2, 3, 16)), _meta((3, 3, 16))),
    lambda: tgd.scalar_mul(BLS, _meta((3, 16)), _meta((3, 24))),
    lambda: hb.kem_batch(tce.CeremonyConfig("ristretto255", 3, 1), _meta((3, 4, 16)), _meta((2, 3, 16)),
                         _meta((32, 256, 4, 16))),
    lambda: hb.kem_batch(tce.CeremonyConfig("secp256k1", 3, 1), _meta((3, 3, 16)), _meta((2, 3, 16)),
                         _meta((32, 256, 3, 16))),
    lambda: tgd.encode_batch(ED, _meta((2, 4, 16))),
    lambda: tgd.encode_batch(BLS, _meta((2, 3, 24))),
    lambda: pk.pt_ladder_horner(tgd.SECP256K1, _meta((3, 3, 16)), _meta((4,)), 3),
    lambda: pk.pt_ladder_horner(ED, _meta((4, 2, 4, 16)), _meta((4,)), 3),
    lambda: pk.pt_ladder_horner(BLS, _meta((3, 3, 24)), _meta((4,)), 3),
    lambda: tgd.eval_point_poly(BLS, _meta((2, 1, 3, 3, 24)), _meta((2, 4)), 3),
    lambda: fk.mod_madd_horner(SECP256K1_N, _meta((4, 3, 16)), _meta((5, 16))),
    lambda: fk.mod_madd_horner(L25519, _meta((3, 16)), _meta((4, 5, 16))),
    lambda: fk.mod_madd_horner(BLS12_381_R, _meta((4, 3, 16)), _meta((5, 16))),
    lambda: fk.mod_madd_dot(SECP256K1_N, _meta((4, 16)), _meta((4, 5, 16))),
    lambda: fk.mod_madd_dot(L25519, _meta((4, 16)), _meta((4, 5, 16))),
    lambda: fk.mod_madd_dot(BLS12_381_R, _meta((4, 16)), _meta((4, 5, 16))),
    lambda: tce._field_dot(BLS12_381_R, _meta((4, 16)), _meta((4, 5, 16))),
    lambda: pk.pt_fixed_base(tgd.SECP256K1, _meta((32, 256, 3, 16)), _meta((4, 16))),
    lambda: pk.pt_fixed_base(ED, _meta((32, 256, 4, 16)), _meta((4, 16))),
    lambda: pk.pt_fixed_base(BLS, _meta((32, 256, 3, 24)), _meta((4, 16))),
    lambda: tgd.fixed_base_mul(BLS, _meta((32, 256, 3, 24)), _meta((2, 3, 16))),
    lambda: pk.pt_tree_sum(tgd.SECP256K1, _meta((2, 5, 3, 16))),
    lambda: pk.pt_tree_sum(ED, _meta((2, 5, 16, 4, 16)), _meta((5,))),
    lambda: pk.pt_tree_sum(BLS, _meta((5, 3, 24))),
    lambda: tgd._tree_reduce(BLS, _meta((2, 5, 3, 24)), 5),
    lambda: tgd.msm_straus(ED, _meta((5, 16)), _meta((2, 5, 4, 16))),
    lambda: fk.mod_batch_inv(SECP256K1_P, _meta((16, 3, 16))),
    lambda: fk.mod_batch_inv(P25519, _meta((16, 3, 16))),
    lambda: fk.mod_batch_inv(BLS12_381_P, _meta((16, 3, 24))),
    lambda: pk.pt_scalar_mul(tgd.SECP256K1, _meta((3, 16, 3, 16)), _meta((2, 3, 16))),
    lambda: pk.pt_scalar_mul(ED, _meta((16, 4, 16)), _meta((5, 16))),
    lambda: pk.pt_scalar_mul(BLS, _meta((3, 16, 3, 24)), _meta((3, 16))),
    lambda: mk.mxu_batch_inv(SECP256K1_P, _meta((16, 3, 16))),
    lambda: mk.mxu_batch_inv(P25519, _meta((16, 3, 16))),
    lambda: mk.mxu_batch_inv(BLS12_381_P, _meta((16, 3, 24))),
    lambda: tgd.affine_canon(tgd.SECP256K1, _meta((2, 3, 16)), mul="gemm"),
    lambda: bk.pt_bucket_sum(tgd.SECP256K1, _meta((2, 5, 3, 16)), _meta((5, 3)), 8),
    lambda: bk.pt_bucket_sum(ED, _meta((2, 5, 4, 16)), _meta((5, 3)), 4),
    lambda: bk.pt_bucket_sum(BLS, _meta((2, 5, 3, 24)), _meta((5, 3)), 8),
    lambda: bk.pt_bucket_close(tgd.SECP256K1, _meta((2, 3, 255, 3, 16))),
    lambda: bk.pt_bucket_close(ED, _meta((2, 3, 15, 4, 16))),
    lambda: bk.pt_bucket_close(BLS, _meta((2, 3, 255, 3, 24))),
    lambda: tgd.msm_pippenger(tgd.SECP256K1, _meta((2, 5, 16)), _meta((2, 5, 3, 16)), 128),
    lambda: tpd.powers(SECP256K1_N, _meta((3, 16)), 3),
    lambda: ts.sign_folded("secp256k1", _meta((16,)), _meta((2, 3, 16))),
    lambda: ts.folded_collect("bls12_381_g1", [_meta((2, 3, 24))]),
    lambda: ts.aggregate(ts.PartialSignatures("ristretto255", (1, 2), [], _meta((2, 2, 4, 16)), []),
                         lam=_meta((2, 16))),
    lambda: tgd.msm(ED, _meta((3, 2, 2, 16)), _meta((3, 2, 2, 4, 16))),
    lambda: trd.ristretto_encode_batch(_meta((2, 4, 16))),
    lambda: trd.ristretto_decode_batch(_meta((2, 16))),
    lambda: tgd.encode_batch_device(tgd.SECP256K1, _meta((2, 3, 16))),
    lambda: tinp.refresh_shares(L25519, 3, 1, [1, 2, 3], random.Random(0), device="meta"),
    lambda: tinp.reshare_shares(SECP256K1_N, 3, 1, [1, 2, 3], 2, 1, random.Random(0), device="meta"),
    lambda: tdl.check_bare_shares(tgh.SECP256K1, [1], [5], [(tgh.SECP256K1.generator(),) * 2], device="meta"),
    lambda: tdl.check_reshare_constants(tgh.RISTRETTO255, (tgh.RISTRETTO255.generator(),) * 2, [1, 2],
                                        [tgh.RISTRETTO255.generator()] * 2, device="meta"),
    lambda: tdl.combine_reshare_commitments(tgh.BLS12_381_G1, _meta((2, 16)),
                                            [(tgh.BLS12_381_G1.generator(),)] * 2),
    lambda: fk.mod_madd_dot(SECP256K1_N, _meta((3, 4, 16)), _meta((3, 4, 5, 16))),
    lambda: fk.mod_madd_dot(BLS12_381_R, _meta((2, 4, 16)), _meta((2, 4, 5, 2, 16))),
    lambda: bk.pt_bucket_sum(tgd.SECP256K1, _meta((3, 2, 5, 3, 16)), _meta((3, 5, 3)), 8),
    lambda: bk.pt_bucket_sum(ED, _meta((3, 1, 5, 4, 16)), _meta((3, 5, 3)), 4),
    lambda: tgd.msm_pippenger(BLS, _meta((3, 1, 5, 16)), _meta((3, 2, 5, 3, 24)), 64),
    lambda: tsvc_engine.run_convoy(tsvc_engine.WarmRuntime(device="meta"),
                                   [tsvc_engine.CeremonyRequest("ristretto255", 5, 2, seed=1)]),
    lambda: tce.aggregate_shares(tce.CeremonyConfig("secp256k1", 4, 1), _meta((4, 5, 16)),
                                 torch.ones(4, dtype=torch.bool, device="meta")),
    lambda: tce.deal_chunked(tce.CeremonyConfig("secp256k1", 4, 1), _meta((4, 2, 16)), _meta((4, 2, 16)),
                             _meta((32, 256, 3, 16)), _meta((32, 256, 3, 16)), chunk=3),
], ids=["mod_madd", "pt_add", "pt_madd", "pt_window_step", "pt_ladder_mul_add", "mod_madd_ed",
        "ed_pt_add", "ed_pt_madd", "ed_pt_double", "pt_double", "ed_pt_ladder_mul_add",
        "ed_window_step", "bucket_accumulate", "ed_bucket_accumulate", "ed_msm_pippenger",
        "mod_madd_bls_base", "mod_madd_bls_scalar", "bls_pt_add", "bls_pt_madd", "bls_pt_double",
        "bls_pt_window_step", "bls_pt_ladder_mul_add", "bls_bucket_accumulate", "bls_msm_pippenger",
        "mod_mul", "mod_mul_ed", "mod_mul_bls", "mxu_mod_mul", "mxu_mod_mul_ed", "mxu_mod_mul_bls",
        "bls_affine_canon", "ed_affine_canon_gemm", "ed_pt_window_step", "ed_scalar_mul", "scalar_mul",
        "bls_scalar_mul", "ed_kem_batch", "kem_batch", "ed_encode_batch", "bls_encode_batch",
        "pt_ladder_horner", "ed_pt_ladder_horner", "bls_pt_ladder_horner", "bls_eval_point_poly",
        "mod_madd_horner", "mod_madd_horner_ed", "mod_madd_horner_bls", "mod_madd_dot", "mod_madd_dot_ed",
        "mod_madd_dot_bls", "bls_field_dot", "pt_fixed_base", "ed_pt_fixed_base", "bls_pt_fixed_base",
        "bls_fixed_base_mul", "pt_tree_sum", "ed_pt_tree_sum_gathered", "bls_pt_tree_sum", "bls_tree_reduce",
        "ed_msm_straus", "mod_batch_inv", "mod_batch_inv_ed", "mod_batch_inv_bls", "pt_scalar_mul",
        "ed_pt_scalar_mul_shared", "bls_pt_scalar_mul", "mxu_batch_inv", "mxu_batch_inv_ed", "mxu_batch_inv_bls",
        "affine_canon_gemm", "pt_bucket_sum", "ed_pt_bucket_sum", "bls_pt_bucket_sum", "pt_bucket_close",
        "ed_pt_bucket_close", "bls_pt_bucket_close", "msm_pippenger_per_row", "powers", "sign_folded",
        "bls_folded_collect", "ed_aggregate", "ed_msm_per_row_pairs", "ristretto_encode", "ristretto_decode",
        "encode_batch_device", "refresh_shares", "reshare_shares", "check_bare_shares", "check_reshare_constants",
        "combine_reshare_commitments", "mod_madd_dot_convoy", "bls_mod_madd_dot_convoy", "pt_bucket_sum_convoy",
        "ed_pt_bucket_sum_convoy", "bls_msm_pippenger_convoy", "service_convoy", "aggregate_shares",
        "deal_chunked"])
def test_wrappers_raise_instead_of_falling_back(call):
    before = [k.launches for k in KERNELS]
    with pytest.raises(ValueError, match="CUDA device"):
        call()
    assert [k.launches for k in KERNELS] == before


@pytest.mark.parametrize("call", [
    lambda: fk.mod_madd(SECP256K1_N, _meta((4, 16)), _meta((4, 1)), _meta((4, 16))),
    lambda: pk.pt_add(tgd.SECP256K1, _meta((4, 3, 16)), _meta((4, 1, 16))),
    lambda: pk.pt_ladder_mul_add(tgd.SECP256K1, _meta((4, 3, 16)), _meta((16,)), _meta((4,)), 3),
    lambda: bk.bucket_accumulate(tgd.SECP256K1, _meta((4, 2, 16)), _meta((4, 3)), 4, 3),
    lambda: bk.bucket_accumulate(tgd.SECP256K1, _meta((2, 4, 3, 16)), _meta((4, 2)), 4, 3),
    lambda: pk.pt_ladder_horner(tgd.SECP256K1, _meta((3, 1, 16)), _meta((4,)), 3),
    lambda: fk.mod_madd_horner(SECP256K1_N, _meta((3, 1)), _meta((4, 16))),
    lambda: fk.mod_madd_dot(SECP256K1_N, _meta((4, 16)), _meta((4, 5, 1))),
    lambda: pk.pt_fixed_base(tgd.SECP256K1, _meta((32, 256, 1, 16)), _meta((4, 16))),
    lambda: pk.pt_tree_sum(tgd.SECP256K1, _meta((2, 5, 1, 16))),
    lambda: pk.pt_tree_sum(tgd.SECP256K1, _meta((2, 5, 16, 1, 16)), _meta((2, 5))),
    lambda: fk.mod_batch_inv(SECP256K1_P, _meta((16, 3, 1))),
    lambda: pk.pt_scalar_mul(tgd.SECP256K1, _meta((3, 16, 1, 16)), _meta((2, 3, 16))),
    lambda: mk.mxu_batch_inv(SECP256K1_P, _meta((16, 3, 1))),
    lambda: bk.pt_bucket_sum(tgd.SECP256K1, _meta((2, 5, 1, 16)), _meta((5, 3)), 4),
    lambda: bk.pt_bucket_sum(tgd.SECP256K1, _meta((2, 5, 3, 16)), _meta((4, 3)), 4),
    lambda: bk.pt_bucket_close(tgd.SECP256K1, _meta((2, 3, 15, 1, 16))),
    lambda: fk.mod_madd_dot(SECP256K1_N, _meta((3, 4, 16)), _meta((3, 4, 5, 1))),
    lambda: bk.pt_bucket_sum(tgd.SECP256K1, _meta((3, 2, 5, 3, 16)), _meta((3, 4, 3)), 4),
], ids=["limbs", "coords", "too_few_axes", "bucket_coords", "bucket_digits", "horner_coords", "horner_limbs",
        "dot_limbs", "fixed_base_coords", "tree_coords", "tree_table_coords", "batch_inv_limbs",
        "scalar_mul_table_coords", "mxu_batch_inv_limbs", "bucket_sum_coords", "bucket_sum_digits",
        "bucket_close_coords", "dot_convoy_limbs", "bucket_sum_convoy_digits"])
def test_wrappers_reject_operands_of_the_wrong_shape(call):
    """A tail that would broadcast (a size-1 limb or coordinate axis)
    is refused before any pointer reaches a kernel."""
    with pytest.raises(ValueError, match="does not end in"):
        call()


def test_unported_variants_raise():
    """A curve or field with no kernel raises before any launch: an
    Edwards curve with another d, a 24-limb curve with another b3 or
    another base field, a field other than the six of csrc/field.cuh (24
    limbs included), a bucket width the kernel does not take.  Every op of
    the three curves has its kernel, the one-launch Edwards window step
    included."""
    other = dataclasses.replace(ED, name="other", const=ED.const + 1)
    assert pk.kernel_for("pt_window_step", ED) is pk.ED_PT_WINDOW_STEP
    assert pk.kernel_for("pt_window_step", ED).source == "edwards_kernels.cu"
    with pytest.raises(NotImplementedError, match="pt_window_step"):
        pk.pt_window_step(other, _meta((2, 4, 16)), _meta((2, 4, 16)), 4)
    for op in ("pt_add", "pt_madd", "pt_double", "pt_window_step", "pt_ladder_mul_add", "pt_ladder_horner",
               "pt_fixed_base", "pt_tree_sum", "pt_scalar_mul"):
        with pytest.raises(NotImplementedError, match=op):
            pk.kernel_for(op, other)
    with pytest.raises(NotImplementedError):
        pk.pt_add(other, _meta((2, 4, 16)), _meta((2, 4, 16)))
    for cs in (other, L24_B3, L24_P):
        with pytest.raises(NotImplementedError, match="bucket_accumulate"):
            bk.bucket_accumulate(cs, _meta((2, 5, cs.ncoords, cs.field.limbs)), _meta((5, 3)), 4, 3)
    for cs in (L24_B3, L24_P):
        for op in ("pt_add", "pt_madd", "pt_double", "pt_window_step", "pt_ladder_mul_add", "pt_ladder_horner",
                   "pt_fixed_base", "pt_tree_sum", "pt_scalar_mul"):
            with pytest.raises(NotImplementedError, match=op):
                pk.kernel_for(op, cs)
        with pytest.raises(NotImplementedError):
            pk.pt_add(cs, _meta((2, 3, 24)), _meta((2, 3, 24)))
    with pytest.raises(NotImplementedError):
        fk.mod_madd(L24_P.field, _meta((2, 24)), _meta((2, 24)), _meta((2, 24)))
    with pytest.raises(NotImplementedError, match="mod_madd_horner"):
        fk.mod_madd_horner(L24_P.field, _meta((2, 3, 24)), _meta((2, 24)))
    with pytest.raises(NotImplementedError, match="mod_madd_dot"):
        fk.mod_madd_dot(L24_P.field, _meta((2, 24)), _meta((2, 3, 24)))
    with pytest.raises(NotImplementedError, match="pt_ladder_horner"):
        pk.pt_ladder_horner(other, _meta((3, 4, 16)), _meta((2,)), 3)
    with pytest.raises(NotImplementedError, match="pt_fixed_base"):
        pk.pt_fixed_base(other, _meta((32, 256, 4, 16)), _meta((2, 16)))
    with pytest.raises(NotImplementedError, match="pt_tree_sum"):
        pk.pt_tree_sum(L24_P, _meta((2, 5, 3, 24)))
    with pytest.raises(ValueError, match="window"):
        bk.bucket_accumulate(ED, _meta((2, 5, 4, 16)), _meta((5, 1)), 16, 1)
    with pytest.raises(NotImplementedError):
        fk.mod_madd(FieldSpec("other", (1 << 255) - 31, 16), _meta((2, 16)), _meta((2, 16)), _meta((2, 16)))
    other_fs = FieldSpec("other", (1 << 255) - 31, 16)
    with pytest.raises(NotImplementedError, match="mod_mul"):
        fk.mod_mul(other_fs, _meta((2, 16)), _meta((2, 16)))
    with pytest.raises(NotImplementedError, match="mxu_mod_mul"):
        mk.mxu_mod_mul(L24_P.field, _meta((2, 24)), _meta((2, 24)))
    for fs in (L25519, SECP256K1_N, BLS12_381_R, L24_P.field):  # built for the three base fields alone
        with pytest.raises(NotImplementedError, match="mod_batch_inv"):
            fk.mod_batch_inv(fs, _meta((2, 3, fs.limbs)))
    with pytest.raises(NotImplementedError, match="pt_scalar_mul"):
        pk.pt_scalar_mul(other, _meta((16, 4, 16)), _meta((2, 16)))
    assert fk.mul_kernel_for(BLS12_381_R) is fk.MOD_MUL_BLS and mk.kernel_for(L25519) is mk.MXU_MOD_MUL_ED
    assert pk.kernel_for("pt_add", ED) is pk.ED_PT_ADD and pk.kernel_for("pt_double", ED) is pk.ED_PT_DOUBLE
    assert pk.kernel_for("pt_double", tgd.SECP256K1) is pk.PT_DOUBLE
    assert bk.kernel_for(ED) is bk.ED_BUCKET_ACCUMULATE
    assert bk.kernel_for(tgd.SECP256K1) is bk.BUCKET_ACCUMULATE
    assert bk.kernel_for(BLS) is bk.BLS_BUCKET_ACCUMULATE
    assert pk.kernel_for("pt_double", BLS) is pk.BLS_PT_DOUBLE
    chained = {"pt_ladder_horner": "ladder_kernels.cu", "pt_fixed_base": "chain_kernels.cu",
               "pt_tree_sum": "chain_kernels.cu", "pt_scalar_mul": "chain_kernels.cu"}
    assert {pk.kernel_for(op, BLS).source for op in pk._VARIANTS if op not in chained} == {"bls_kernels.cu"}
    assert all(pk.kernel_for(op, BLS).source == src for op, src in chained.items())
    for cs in (ED, tgd.SECP256K1, BLS):
        assert all(pk.kernel_for(op, cs) in pk.KERNELS for op in pk._VARIANTS)


@pytest.mark.parametrize("variants", [*pk._VARIANTS.values(), bk._VARIANTS, bk._SUM_VARIANTS, bk._CLOSE_VARIANTS],
                         ids=[*pk._VARIANTS, "bucket_accumulate", "pt_bucket_sum", "pt_bucket_close"])
def test_variants_of_an_op_share_one_calling_convention(variants):
    """Every curve's variant of an op is its own C entry, with its own
    launch count, taking the same arguments: the wrapper passes them alike
    whatever the curve."""
    kernels = list(variants.values())
    assert len({k.symbol for k in kernels}) == len({k.name for k in kernels}) == len(kernels)
    assert len({tuple(k._argtypes) for k in kernels}) == 1


def test_cpu_tensors_run_the_plain_versions_uncounted():
    p = tgd.identity(tgd.SECP256K1, (2,), device="cpu")
    before = pk.PT_ADD.launches
    assert torch.equal(pk.pt_add(tgd.SECP256K1, p, p), pk.pt_add_plain(tgd.SECP256K1, p, p))
    assert pk.PT_ADD.launches == before
    digits = torch.tensor([[0], [3]], dtype=torch.int32)  # (m, nw) = (2, 1)
    before = bk.BUCKET_ACCUMULATE.launches
    assert torch.equal(bk.bucket_accumulate(tgd.SECP256K1, p, digits, 4, 1),
                       bk.bucket_accumulate_plain(tgd.SECP256K1, p, digits, 16))
    assert bk.BUCKET_ACCUMULATE.launches == before


def test_entry_points_default_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tce.BatchedCeremony("secp256k1", 4, 1, b"x", None)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tce.resolve_device("cuda")
    group = tgh.RISTRETTO255
    env = tcm.Environment.init(group, 1, 3, b"x")
    keys = [tpk.MemberCommunicationKey(tel.Keypair.from_secret(group, k)) for k in (2, 3, 5)]
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcmb.batched_dealing(env, None, keys)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcmb.batched_share_verification([None], [], None)
    for court in (tcb.adjudicate_round1, tcb.adjudicate_round1_batch):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            court(group, tgd.RISTRETTO255, env.commitment_key, [], {})
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tcb.check_randomized_shares_batch(group, tgd.RISTRETTO255, env.commitment_key, [1], [1], [1], [()])
    assert tce.resolve_device("cpu") == torch.device("cpu")


def test_epoch_chaos_harness_defaults_to_cuda(tmp_path, monkeypatch):
    """run_epochs_with_faults drives its EpochManagers on the card unless
    the caller passes the CPU; the fixed-base table builders take their
    device from the caller, and a CUDA device with no card raises."""
    from dkg_tpu_torch.groups import precompute as tgp
    from dkg_tpu_torch.net import faults as tnf

    assert inspect.signature(tnf.run_epochs_with_faults).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    monkeypatch.setenv("DKG_TPU_TABLE_CACHE", str(tmp_path))
    cs = tgd.RISTRETTO255
    for build_table in (lambda: tgd.fixed_base_table_dev(cs, tgd.gen_host(cs), 4, device="cuda"),
                        lambda: tgp.base_table(cs, tgd.gen_host(cs), 16, device="cuda")):
        with pytest.raises((RuntimeError, AssertionError)):
            build_table()


def test_party_mesh_defaults_to_cuda():
    """The mesh's entry points put their ranks on the card unless the
    caller passes the CPU: spawn's default device is "cuda", and without
    a card spawn, make_mesh, global_party_mesh and init_multihost raise
    before any process starts or any rendezvous is tried."""
    from dkg_tpu_torch.parallel import hostmesh, multihost
    from dkg_tpu_torch.parallel import mesh as pm

    assert inspect.signature(hostmesh.spawn).parameters["device"].default == "cuda"
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is usable")
    for entry in (lambda: hostmesh.spawn(print, 2), pm.make_mesh, multihost.global_party_mesh,
                  lambda: multihost.init_multihost("127.0.0.1:1", 2, 0)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            entry()
    assert pm.make_mesh(device="cpu").device == torch.device("cpu")


def test_build_needs_nvcc(monkeypatch):
    monkeypatch.setattr(build.shutil, "which", lambda name: None)
    monkeypatch.setattr(build.pathlib.Path, "exists", lambda self: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()


def test_library_path_tracks_sources():
    path = build.library_path("point_kernels.cu")
    assert path.parent == build.BUILD_DIR and path.name.startswith("point_kernels-")
    assert path != build.library_path("field_kernels.cu")
    assert build.library_path("bls_kernels.cu").name.startswith("bls_kernels-")
    assert {k.source for k in KERNELS} == set(build.SOURCES)
    assert str(build.BUILD_DIR).startswith(str(REPO / "build"))


@pytest.mark.parametrize("kernel", KERNELS, ids=[k.name for k in KERNELS])
def test_every_kernel_entry_is_in_its_source(kernel):
    """Each wrapper's C entry is defined, with C linkage, in the source it
    builds, so a launch never reaches a missing symbol on the card."""
    text = (build.CSRC / kernel.source).read_text()
    assert 'extern "C"' in text and re.search(rf"\bint {kernel.symbol}\(", text)
    assert "dkg_error_string" in text
