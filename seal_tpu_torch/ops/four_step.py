"""Four-step negacyclic NTT: the stage's plain version and the transforms.

Port of ``seal_tpu/ops/mxu_ntt.py`` and of the staged branch of
``seal_tpu/ops/pallas_mxu_ntt.py`` (``pallas_ntt_forward`` /
``pallas_ntt_inverse``, ``:348-388``).  One *stage* is, for every
(poly, limb) row of the data,

    out[m, t] = (sum_kappa B[m, kappa] * x[kappa, t]) mod q   (then * T[m, t])

with B a (M, K) constant matrix of the limb and T an optional Shoup twiddle:
what ``_stage_kernel`` computes.  A stage names its matrix: ``"w"``,
``"f"``, ``"finv"`` or ``"winv"`` of :class:`FourStepTables`, each a
butterfly transform whose root table the tables also keep.  The JAX package
reaches exactness through int8 digit planes; here the products are 64x64 ->
128-bit and summed exactly, which gives the same reduced residues.

A stage reads its input and writes its output through a :class:`StageSpec`:
the element (kappa, t) of a row sits at ``kappa * x_strides[0] + t *
x_strides[1]`` and the output element (m, t) at ``m * out_strides[0] + t *
out_strides[1]``.  The transposes between the two stages of the JAX package
(``pallas_mxu_ntt.py:355-358, 380-383``) become strides, so a transform is
two stage calls and nothing else.  The twiddle is read at the output
element's position.  Inputs may be lazy, below 4q: a stage reduces them to
[0, q) as it reads them (``pallas_mxu_ntt.py:348, 377``).  Outputs are in
[0, q).

``stage_plain`` is the plain PyTorch version; ``ops/cuda_four_step.py``
holds the card's kernel with the same contract.  ``four_step_forward`` and
``four_step_inverse`` take either as ``stage``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from ..ntt_tables import FourStepTables
from . import u64 as U

# Products summed exactly before a reduction: 64 * (q-1)^2 < 2^128 for
# q < 2^61 (the JAX package's kchunk bound, ntt_tables.py:372-378, allows
# the same or more).
MAX_CHUNK = 64
MAX_Q_BITS = 61
# Elements of one chunk's product tensor, bounding the plain version's memory.
_PLAIN_CHUNK_ELEMENTS = 1 << 22
TRANSFORMS = ("w", "f", "finv", "winv")
INVERSE_TRANSFORMS = ("finv", "winv")


def check_transform(ft: FourStepTables, name: str, M: int) -> None:
    """Raise unless ``name`` is one of :data:`TRANSFORMS` and M-point: W
    and Winv are n1-point, F and Finv n2-point."""
    if name not in TRANSFORMS:
        raise ValueError(f"a stage's transform is one of {TRANSFORMS}, got {name!r}")
    size = ft.n1 if name in ("w", "winv") else ft.n2
    if size != M:
        raise ValueError(f"transform {name!r} is {size}-point, the stage is {M}-point")


class StageSpec(NamedTuple):
    """Shape and layout of one stage over rows of n = K * ncols elements."""

    M: int
    K: int
    ncols: int
    x_strides: Tuple[int, int]     # (kappa, t)
    out_strides: Tuple[int, int]   # (m, t)


def forward_specs(ft: FourStepTables) -> Tuple[StageSpec, StageSpec]:
    """Stage A reads the natural (r, c) layout and writes h in (t1, c);
    stage B reads h column-wise and writes out[t1, t2] at t1 * n2 + t2."""
    n1, n2 = ft.n1, ft.n2
    return (StageSpec(n1, n1, n2, (n2, 1), (n2, 1)),
            StageSpec(n2, n2, n1, (1, n2), (1, n2)))


def inverse_specs(ft: FourStepTables) -> Tuple[StageSpec, StageSpec]:
    """Finv contracts over t2 of the (t1, t2) input and writes ht in
    (t1, c); Winv contracts over t1 and writes the natural (r, c) layout."""
    n1, n2 = ft.n1, ft.n2
    return (StageSpec(n2, n2, n1, (1, n2), (1, n2)),
            StageSpec(n1, n1, n2, (n2, 1), (n2, 1)))


def _strided(flat: torch.Tensor, k: int, n: int, rows: int, strides, shape) -> torch.Tensor:
    """(rows, n) storage -> (rows // k, k, shape[0], shape[1]) strided view."""
    return flat.as_strided((rows // k, k, *shape), (k * n, n, *strides))


def stage_plain(x: torch.Tensor, name: str, ft: FourStepTables, spec: StageSpec,
                twiddle: Optional[Tuple[torch.Tensor, torch.Tensor]] = None) -> torch.Tensor:
    """One stage in plain PyTorch on the tensors' device: the dense product
    with the named transform's (k, M, K) matrix.

    ``x``: int64 (..., k, n), values below 4q; ``name``: one of
    :data:`TRANSFORMS`; ``twiddle``: (op, qt), each (k, n), or None.
    Returns (..., k, n) in [0, q).
    """
    *lead, k, n = x.shape
    M, K, ncols = spec.M, spec.K, spec.ncols
    check_transform(ft, name, M)
    b = getattr(ft, name)
    rows = x.numel() // n
    q = ft.q[:, :, None]                                            # (k, 1, 1)
    two_q = 2 * q
    flat = x.contiguous().reshape(rows, n)
    xv = _strided(flat, k, n, rows, spec.x_strides, (K, ncols))     # (L, k, K, ncols)
    xv = torch.where(xv >= two_q, xv - two_q, xv)
    xv = torch.where(xv >= q, xv - q, xv)

    per_kappa = max(1, (rows // k) * k * M * ncols)
    chunk = max(1, min(MAX_CHUNK, K, _PLAIN_CHUNK_ELEMENTS // per_kappa))
    acc = None
    for c0 in range(0, K, chunk):
        xs = xv[:, :, None, c0:c0 + chunk, :]                       # (L, k, 1, c, ncols)
        bs = b[None, :, :, c0:c0 + chunk, None]                     # (1, k, M, c, 1)
        w0, w1, w2, w3 = (w.sum(dim=-2) for w in U._words_mul_wide(bs, xs))
        # Each word sum is below chunk * 2^32; carry them into a u128.
        w1 = w1 + (w0 >> 32)
        w2 = w2 + (w1 >> 32)
        w3 = w3 + (w2 >> 32)
        lo = U._join(w0 & U._M32, w1 & U._M32)
        hi = U._join(w2 & U._M32, w3)
        part = U.barrett_reduce_128((lo, hi), q, ft.ratio_lo[:, :, None], ft.ratio_hi[:, :, None])
        acc = part if acc is None else U.add_mod(acc, part, q)       # (L, k, M, ncols)
    if twiddle is not None:
        op = twiddle[0].as_strided((k, M, ncols), (n, *spec.out_strides))
        qt = twiddle[1].as_strided((k, M, ncols), (n, *spec.out_strides))
        acc = U.mul_mod_shoup(acc, op, qt, q)
    out = torch.empty((rows, n), dtype=torch.int64, device=x.device)
    _strided(out, k, n, rows, spec.out_strides, (M, ncols)).copy_(acc)
    return out.reshape(*lead, k, n)


def four_step_forward(x: torch.Tensor, ft: FourStepTables, stage=stage_plain) -> torch.Tensor:
    """Forward negacyclic NTT of (..., k, n) data below 4q; output in [0, q)
    in the butterflies' bit-reversed order.  Two stage calls."""
    spec_a, spec_b = forward_specs(ft)
    h = stage(x, "w", ft, spec_a, (ft.tw_op, ft.tw_qt))
    return stage(h, "f", ft, spec_b)


def four_step_inverse(x: torch.Tensor, ft: FourStepTables, stage=stage_plain) -> torch.Tensor:
    """Inverse negacyclic NTT of (..., k, n) data below 2q, 1/n (and the
    tables' inv_scale) folded in; output in [0, q).  Two stage calls."""
    spec_a, spec_b = inverse_specs(ft)
    h = stage(x, "finv", ft, spec_a, (ft.twi_op, ft.twi_qt))
    return stage(h, "winv", ft, spec_b)

