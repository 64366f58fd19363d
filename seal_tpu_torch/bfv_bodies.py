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

:func:`multiply` runs the steps in order.  Each step also takes a rank's
own q limbs [lo, hi) of a mesh (``parallel/sharded.bfv_multiply``), which
exchanges the two conversions' partial sums between the steps:

1. the extension: the conversion q -> Bsk U {m_tilde} of x m_tilde
   (``ops/rns.fastbconv_m_tilde``);
2. :func:`product`: the small Montgomery reduction to Bsk, the forward NTT
   over q U Bsk, the dyadic convolution and the t-scaled inverse NTT;
3. the floor's conversion q -> Bsk (``ops/rns.fast_convert_array`` with
   ``tool.conv_q_to_Bsk``);
4. :func:`floor_sk`: the floor's tail into Bsk and the Shenoy-Kumaresan
   conversion back to the q limbs.

A rank computes the whole Bsk part of steps 2 and 4 from the exchanged
sums, as every rank of its group does.
"""

from __future__ import annotations

import torch

from .ckks_bodies import convolve
from .context import ContextData
from .ntt_tables import LimbTables
from .ops import ntt as NTT
from .ops import rns as R
from .rns_host import HostRNSTool


def operands(d1: torch.Tensor, d2: torch.Tensor) -> torch.Tensor:
    """The product's input: both operands along the poly axis, or the one
    operand of a square (``d2 is d1``), which is extended and transformed
    once."""
    return d1 if d2 is d1 else torch.cat([d1, d2], dim=-3)


def product(x: torch.Tensor, ext_sum: torch.Tensor, s1: int, square: bool, tool: HostRNSTool,
            t: LimbTables) -> torch.Tensor:
    """(2)-(5): the small Montgomery reduction of the whole extension
    ``ext_sum`` to Bsk, then the forward NTT of the q limbs ``x`` holds and
    Bsk in one call over ``t`` (those q limbs and Bsk), the convolution of
    the first ``s1`` polys with the rest (or with themselves when
    ``square``), and the t-scaled inverse NTT: (..., s1 + s2 - 1, rows, n)."""
    ext = R.sm_mrq(ext_sum, tool)
    y = NTT.forward(torch.cat([x, ext], dim=-2), t, lazy=True)
    e1 = y[..., :s1, :, :]
    return NTT.inverse(convolve(e1, e1 if square else y[..., s1:, :, :], t), t)


def floor_sk(z: torch.Tensor, m: int, dest: torch.Tensor, tool: HostRNSTool, lo: int = 0) -> torch.Tensor:
    """(7)-(8): floor(z / q) into Bsk from the whole conversion ``dest``,
    then the Shenoy-Kumaresan conversion to the q limbs [lo, lo + m):
    (..., size, m, n) in [0, q_i)."""
    return R.fastbconv_sk(R.fast_floor_finish(z[..., m:, :], dest, tool), tool, lo, lo + m)


def multiply(d1: torch.Tensor, d2: torch.Tensor, cd: ContextData) -> torch.Tensor:
    """BEHZ product of (..., s1, k, n) and (..., s2, k, n) coefficient-form
    data at ``cd``'s level: (..., s1 + s2 - 1, k, n) in [0, q_i).  Passing
    the same tensor twice squares it (one extension, one transform)."""
    tool = cd.rns_tool
    k = d1.shape[-2]
    x = operands(d1, d2)
    z = product(x, R.fastbconv_m_tilde(x, tool), d1.shape[-3], d2 is d1, tool, cd.behz_limb_tables(d1.device))
    return floor_sk(z, k, R.fast_convert_array(z[..., :k, :], tool.conv_q_to_Bsk), tool)
