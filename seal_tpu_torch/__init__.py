"""seal-tpu-torch: seal-tpu in PyTorch, with CUDA kernels for the H100.

A port of ``seal_tpu`` (JAX on a TPU) to PyTorch on an NVIDIA H100, with
the same public surface: EncryptionParameters and SealContext,
KeyGenerator (secret, public, relinearization and Galois keys, seeded or
not), Encryptor, Decryptor (``decrypt_batch`` too), the Evaluator of all
three schemes (CKKS, BFV with the BEHZ multiply, BGV with its exact
conversion and correction factors), BatchEncoder and CKKSEncoder, the
batched and multi-device layer in ``parallel``, the validity checks of
``valcheck`` and Microsoft SEAL's wire format in ``serialization``, which
loads and saves every object byte for byte as the reference and the JAX
package do.

Four hand-written Hopper kernels carry the ring arithmetic: the negacyclic
NTT up to N=32768 (``csrc/ntt.cu``), the fused key switch up to N=32768
(``csrc/switch_key.cu``), the four-step stage of every NTT above N=32768
(``csrc/four_step.cu``) and the distributed NTT's corner turn
(``csrc/corner_turn.cu``).  Two more sample keygen's keys and symmetric
encryptions on the card, as the JAX package samples on its device: the
BLAKE2xb stream (``csrc/blake2xb.cu``) and the uniform and CBD samplers
over it (``csrc/sample.cu``).  Serialization, the other samplers and the
checks run on the host in numpy, as in the JAX package.  The package
imports neither JAX nor ``seal_tpu``.

Contexts live on the card by default; ``SealContext(..., device="cpu")``
runs the plain PyTorch versions on the CPU, and every object loaded for a
context lies on its device.
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
from .utils import print_parameters
from . import serialization

__version__ = "0.1.0"

__all__ = [
    "BatchEncoder", "CKKSEncoder", "Ciphertext", "CoeffModulus", "Decryptor", "EncryptionParameterQualifiers",
    "EncryptionParameters", "Encryptor", "ErrorType", "Evaluator", "GaloisKeys", "KSwitchKeys", "KeyGenerator",
    "Modulus", "PARMS_ID_ZERO", "PRNGType", "ParmsId", "PlainModulus", "Plaintext", "PublicKey", "RelinKeys",
    "SchemeType", "SealContext", "SecretKey", "SecurityLevel", "UniformRandomGeneratorFactory", "print_parameters",
    "serialization",
]
