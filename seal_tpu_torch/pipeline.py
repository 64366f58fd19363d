"""The server pipelines: one function over raw ciphertext tensors each,
what an HE server runs per request.

Port of ``seal_tpu/pipeline.py``: CKKS multiply -> relinearize -> rescale
(``build_ckks_mult_relin_rescale``) and BFV multiply -> relinearize
(``build_bfv_mult_relin``).
"""

from __future__ import annotations

from . import bfv_bodies
from .context import SealContext
from .ckks_bodies import convolve
from .evaluator import Evaluator
from .ops import rns as R


def build_ckks_mult_relin_rescale(context: SealContext):
    """Returns fn(d1, d2, kc0, kc1) -> the rescaled product data.

    d1, d2: int64 (2, k, n) — NTT-form size-2 ciphertexts at the first
    level.  kc0/kc1: stacked relinearization key components (D, k_key, n).
    Returns (2, k - 1, n).
    """
    ev = Evaluator(context)
    cd = context.first_context_data()

    def fn(d1, d2, kc0, kc1):
        t = cd.limb_tables()
        data3 = convolve(d1, d2, t)
        data2 = ev._switch_key_body(cd, 2, data3[:2], data3[2], kc0, kc1)
        return R.divide_and_round_q_last_ntt(data2, cd.rns_tool, t)

    return fn


def build_bfv_mult_relin(context: SealContext):
    """Returns fn(d1, d2, kc0, kc1) -> the relinearized BEHZ product.

    d1, d2: int64 (2, k, n) — coefficient-form size-2 BFV ciphertexts at the
    first level.  kc0/kc1: stacked relinearization key components
    (D, k_key, n).  Returns (2, k, n).
    """
    ev = Evaluator(context)
    cd = context.first_context_data()

    def fn(d1, d2, kc0, kc1):
        data3 = bfv_bodies.multiply(d1, d2, cd)
        return ev._switch_key_body(cd, 2, data3[:2], data3[2], kc0, kc1)

    return fn
