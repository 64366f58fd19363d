"""The CKKS server pipeline: ct x ct multiply -> relinearize -> rescale.

Port of ``seal_tpu/pipeline.py:build_ckks_mult_relin_rescale``: one
function over raw ciphertext tensors, what an HE server runs per request.
"""

from __future__ import annotations

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
