"""seal-tpu-torch: the seal-tpu server path in PyTorch, with CUDA kernels.

A port of ``seal_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.  This
slice covers what a CKKS server runs per request: ciphertext x ciphertext
multiply, relinearize and rescale (``pipeline.build_ckks_mult_relin_rescale``),
with two hand-written Hopper kernels: the negacyclic NTT
(``csrc/ntt.cu``) and the fused key-switch contraction
(``csrc/switch_key.cu``).  The package imports neither JAX nor ``seal_tpu``.

Contexts live on the card by default; ``SealContext(..., device="cpu")``
runs the plain PyTorch versions on the CPU.
"""

from .modulus import CoeffModulus, Modulus, SecurityLevel
from .params import EncryptionParameters, ParmsId, PARMS_ID_ZERO, SchemeType
from .context import SealContext, EncryptionParameterQualifiers, ErrorType
from .data import Ciphertext, KSwitchKeys, RelinKeys
from .evaluator import Evaluator

__version__ = "0.1.0"

__all__ = [
    "Ciphertext", "CoeffModulus", "EncryptionParameterQualifiers", "EncryptionParameters",
    "ErrorType", "Evaluator", "KSwitchKeys", "Modulus", "PARMS_ID_ZERO", "ParmsId",
    "RelinKeys", "SchemeType", "SealContext", "SecurityLevel",
]
