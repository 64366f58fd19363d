"""The BFV multiply's ring body, on local tensors.

The BEHZ multiplication (``seal_tpu/evaluator.py:364-451``, the reference's
``evaluator.cpp:395-567``) over coefficient-form (..., size, k, n) data with
any leading batch axes, shared by ``Evaluator`` and ``BatchEvaluator`` as
``ckks_bodies.convolve`` is.  The q limbs and the Bsk limbs travel together
as one (..., size, k + k_bsk, n) tensor under one table bundle
(``ContextData.behz_limb_tables``: q U Bsk, t folded into the inverse), so
each transform is one call for both bases: on the card kernel A runs twice
per multiply, the forward and the t-scaled inverse.  The base conversions
(``ops/rns.py``) and the convolution are elementwise mod-q arithmetic in
plain PyTorch.  Relinearization is the shared key switch
(``ckks_bodies.py``), which the plan runs on BFV's coefficient form.
"""

from __future__ import annotations

import torch

from .ckks_bodies import convolve
from .context import ContextData
from .ops import ntt as NTT
from .ops import rns as R


def multiply(d1: torch.Tensor, d2: torch.Tensor, cd: ContextData) -> torch.Tensor:
    """BEHZ product of (..., s1, k, n) and (..., s2, k, n) coefficient-form
    data at ``cd``'s level: (..., s1 + s2 - 1, k, n) in [0, q_i).  Passing
    the same tensor twice squares it (one extension, one transform)."""
    tool = cd.rns_tool
    t = cd.behz_limb_tables(d1.device)
    square = d2 is d1
    x = d1 if square else torch.cat([d1, d2], dim=-3)
    # (1)-(3): x m_tilde converted to Bsk U {m_tilde}, the small Montgomery
    # reduction back to Bsk, then both bases to the NTT domain at once
    ext = R.sm_mrq(R.fastbconv_m_tilde(x, tool), tool)
    y = NTT.forward(torch.cat([x, ext], dim=-2), t, lazy=True)
    s1 = d1.shape[-3]
    e1 = y[..., :s1, :, :]
    # (4) the dyadic convolution over q U Bsk
    dest = convolve(e1, e1 if square else y[..., s1:, :, :], t)
    # (5)-(8): the t-scaled inverse over both bases, floor(. / q) into Bsk,
    # and the Shenoy-Kumaresan conversion back to q
    return R.fastbconv_sk(R.fast_floor(NTT.inverse(dest, t), tool), tool)
