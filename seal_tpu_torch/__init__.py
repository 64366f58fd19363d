"""seal-tpu-torch: the seal-tpu server path in PyTorch, with CUDA kernels.

A port of ``seal_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100.  It
covers a CKKS user's whole computation: keygen (with Galois keys), encode,
encrypt, the whole CKKS evaluator (multiply, relinearize, rescale, the
plaintext ops, modulus switching, rotations and conjugation), decrypt and
decode, at every ring size up to N=131072; and BFV's: the BatchEncoder,
encryption, decryption and the noise budget, and the BFV evaluator (the
BEHZ multiply, relinearize, the modulus switch, the plaintext ops, row and
column rotations).  Three hand-written Hopper kernels carry it: the
negacyclic NTT up to N=32768 (``csrc/ntt.cu``), the fused key-switch
contraction up to N=32768 (``csrc/switch_key.cu``) and the four-step stage
that serves every NTT above N=32768 (``csrc/four_step.cu``); a fourth, the
corner turn (``csrc/corner_turn.cu``), is the distributed NTT's exchange.
The package imports neither JAX nor ``seal_tpu``.

Contexts live on the card by default; ``SealContext(..., device="cpu")``
runs the plain PyTorch versions on the CPU.
"""

from .modulus import CoeffModulus, Modulus, PlainModulus, SecurityLevel
from .params import EncryptionParameters, ParmsId, PARMS_ID_ZERO, SchemeType
from .context import SealContext, EncryptionParameterQualifiers, ErrorType
from .data import Ciphertext, GaloisKeys, KSwitchKeys, Plaintext, PublicKey, RelinKeys, SecretKey
from .evaluator import Evaluator
from .keygen import KeyGenerator
from .encryptor import Encryptor
from .decryptor import Decryptor
from .ckks_encoder import CKKSEncoder
from .encoders import BatchEncoder
from .random import PRNGType, UniformRandomGeneratorFactory

__version__ = "0.1.0"

__all__ = [
    "BatchEncoder", "CKKSEncoder", "Ciphertext", "CoeffModulus", "Decryptor", "EncryptionParameterQualifiers",
    "EncryptionParameters", "Encryptor", "ErrorType", "Evaluator", "GaloisKeys", "KSwitchKeys", "KeyGenerator",
    "Modulus", "PARMS_ID_ZERO", "PRNGType", "ParmsId", "PlainModulus", "Plaintext", "PublicKey", "RelinKeys",
    "SchemeType", "SealContext", "SecretKey", "SecurityLevel", "UniformRandomGeneratorFactory",
]
