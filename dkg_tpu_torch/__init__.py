"""dkg_tpu_torch — the batched GJKR ceremony on PyTorch and CUDA.

A port of ``dkg_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100, held
to it limb for limb.  The same module names as the JAX package: field
limb arithmetic (``fields``), curve points (``groups``), polynomial
evaluation (``poly``), hashes, ciphers, commitments and proofs
(``crypto``), the ceremony engine and the committee wire protocol
(``dkg``), threshold signing (``sign``) and phase tracing
(``utils``).  The hand-written CUDA kernels live in ``csrc/``; their
wrappers and plain PyTorch versions in ``ops/``.

Limbs are int32 tensors (values < 2**16).  Entry points run on the card
(``device="cuda"``) unless the caller passes ``device="cpu"``, where each
kernel wrapper runs its plain version.
"""

__version__ = "0.1.0"
