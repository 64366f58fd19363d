"""CKKSEncoder: canonical-embedding encode and decode.

Port of ``seal_tpu/ckks_encoder.py`` (counterpart of ``ckks.{h,cpp}``) on
its host ladder (``SEAL_TPU_DEVICE_FFT=0``, ``SEAL_TPU_DEVICE_COMPOSE=0``),
in float64 and int64 tensors on the context's device.  N/2 complex slots map
to the coefficients through the g=3 orbit index map; encode runs the inverse
slot FFT with 1/n and the scale fused (``ops/slot_fft.py``), rounds each
coefficient half away from zero to an exact integer, reduces it into every
RNS limb and takes the forward NTT.  Decode runs the inverse NTT, the exact
CRT composition and the centered double ladder (``ops/crt_compose.py``),
then the forward slot FFT.  Results have the bits of the JAX package's
ladder on the CPU and on the card.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence, Union

import numpy as np
import torch

from . import numth
from .context import ContextData, SealContext
from .data import Plaintext
from .ntt_tables import u64_tensor
from .params import ParmsId, SchemeType
from .ops import crt_compose as CC
from .ops import ntt as NTT
from .ops import slot_fft as SF
from .ops import u64 as U
from .ops.rns import _c, _cshoup

_TWO_53 = 9007199254740992.0


class CKKSEncoder:
    def __init__(self, context: SealContext):
        if not context.parameters_set:
            raise ValueError("encryption parameters are not set correctly")
        cd = context.first_context_data()
        if cd.parms.scheme != SchemeType.CKKS:
            raise ValueError("unsupported scheme")
        self.context = context
        n = cd.parms.poly_modulus_degree
        self.n = n
        self.slots = n >> 1
        #: reference-parity alias (CKKSEncoder::slot_count, ckks.h)
        self.slot_count = self.slots
        logn = n.bit_length() - 1
        m = n << 1
        dev = context.device

        # index map (ckks.cpp:33-50)
        index_map = np.zeros(n, dtype=np.int64)
        pos = 1
        for i in range(self.slot_count):
            index_map[i] = numth.reverse_bits((pos - 1) >> 1, logn)
            index_map[self.slot_count | i] = numth.reverse_bits((m - pos - 1) >> 1, logn)
            pos = (pos * 3) & (m - 1)
        self.index_map = torch.from_numpy(index_map).to(dev)
        fwd, inv = SF.root_tables(n)
        self._roots = (torch.from_numpy(fwd.real.copy()).to(dev), torch.from_numpy(fwd.imag.copy()).to(dev))
        self._inv_roots = (torch.from_numpy(inv.real.copy()).to(dev), torch.from_numpy(inv.imag.copy()).to(dev))
        self._inv_punctured: Dict[ParmsId, tuple] = {}

    def _level(self, parms_id: ParmsId) -> ContextData:
        cd = self.context.get_context_data(parms_id)
        if cd is None:
            raise ValueError("parms_id is not valid for encryption parameters")
        return cd

    # -- encode ------------------------------------------------------------
    def encode(self, values: Union[Sequence[complex], Sequence[float], complex, float, int],
               parms_id_or_scale=None, scale: float = None, parms_id: ParmsId = None) -> Plaintext:
        """Encode a vector of complex or real values, or a scalar into every
        slot: ``encode(values, scale)`` or ``encode(values, parms_id, scale)``."""
        if scale is None and isinstance(parms_id_or_scale, (int, float)) and parms_id is None:
            scale = float(parms_id_or_scale)
            parms_id = self.context.first_parms_id
        else:
            if parms_id_or_scale is not None and not isinstance(parms_id_or_scale, (int, float)):
                parms_id = tuple(parms_id_or_scale)
            if parms_id is None:
                parms_id = self.context.first_parms_id
            if scale is None:
                raise ValueError("scale must be given")
        if np.isscalar(values) or isinstance(values, (complex, float, int)):
            return self._encode_scalar(complex(values), parms_id, scale)
        return self._encode_vector(np.asarray(values, dtype=np.complex128), parms_id, scale)

    def _check_scale(self, scale: float, cd: ContextData):
        if not (scale > 0 and math.floor(math.log2(scale)) < cd.total_coeff_modulus_bit_count):
            raise ValueError("scale out of bounds")

    def _encode_vector(self, values: np.ndarray, parms_id: ParmsId, scale: float) -> Plaintext:
        cd = self._level(parms_id)
        if len(values) > self.slot_count:
            raise ValueError("values size is too large")
        if not np.isfinite(values).all():
            raise ValueError("values must be finite")
        self._check_scale(scale, cd)
        n, dev = self.n, self.context.device
        count = len(values)
        re = torch.zeros(n, dtype=torch.float64, device=dev)
        im = torch.zeros(n, dtype=torch.float64, device=dev)
        v_re = torch.from_numpy(values.real.copy()).to(dev)
        v_im = torch.from_numpy(values.imag.copy()).to(dev)
        re[self.index_map[:count]] = v_re
        im[self.index_map[:count]] = v_im
        re[self.index_map[self.slot_count:self.slot_count + count]] = v_re
        im[self.index_map[self.slot_count:self.slot_count + count]] = -v_im
        coeffs, _ = SF.fft_from_rev((re, im), self._inv_roots, scale / n)

        max_coeff = float(coeffs.abs().max())
        if not math.isfinite(max_coeff):
            raise ValueError("encoded values are too large")
        if max(int(math.ceil(math.log2(max(max_coeff, 1.0)))), 0) + 1 >= cd.total_coeff_modulus_bit_count:
            raise ValueError("encoded values are too large")
        p = Plaintext()
        p.parms_id = parms_id
        p.scale = scale
        p.rns_data = NTT.forward(self._round_to_rns(coeffs, cd, max_coeff), cd.limb_tables())
        return p

    @staticmethod
    def _round_to_rns(coeffs: torch.Tensor, cd: ContextData, max_coeff: float) -> torch.Tensor:
        """Round half away from zero and reduce into every limb, (k, n).

        Below 2^53 a coefficient rounds as floor(|c| + 0.5); above, it is an
        integer m * 2^e (53-bit m), reduced as (m mod q) (2^e mod q) -- the
        reference's wide tiers (ckks.h:593-667), as the JAX package does.
        """
        t = cd.limb_tables()
        qv = cd.coeff_modulus_values
        absc = coeffs.abs()
        neg = torch.signbit(coeffs)
        small = absc < _TWO_53
        red = torch.floor(torch.where(small, absc, 0.0) + 0.5).to(torch.int64) % t.q      # (k, n)
        if max_coeff >= _TWO_53:
            mant, exp = torch.frexp(absc)
            m = torch.round(mant * _TWO_53).to(torch.int64)
            e = torch.where(small, 0, exp.to(torch.int64) - 53)
            max_e = int(e.max()) + 1
            pow2 = u64_tensor([[pow(2, j, q) for j in range(max_e)] for q in qv], coeffs.device)
            wide = U.mul_mod(m % t.q, pow2[:, e], t.q, t.ratio_lo, t.ratio_hi)
            red = torch.where(small, red, wide)
        return torch.where(neg, U.neg_mod(red, t.q), red)

    def _encode_scalar(self, value: complex, parms_id: ParmsId, scale: float) -> Plaintext:
        """A real scalar is the constant polynomial round(v * scale), whose
        NTT is itself (ckks.cpp:75-230); a complex one takes the vector path."""
        if value.imag != 0:
            return self._encode_vector(np.full(self.slot_count, value, dtype=np.complex128), parms_id, scale)
        cd = self._level(parms_id)
        self._check_scale(scale, cd)
        coeffd = value.real * scale
        if not math.isfinite(coeffd):
            raise ValueError("encoded value is too large")
        rounded = int(math.floor(abs(coeffd) + 0.5)) * (-1 if coeffd < 0 else 1)
        if abs(rounded).bit_length() + 1 >= cd.total_coeff_modulus_bit_count:
            raise ValueError("encoded value is too large")
        p = Plaintext()
        p.parms_id = parms_id
        p.scale = scale
        p.rns_data = _c([rounded % q for q in cd.coeff_modulus_values], self.context.device).expand(-1, self.n).contiguous()
        return p

    def encode_int(self, value: int, parms_id: ParmsId = None) -> Plaintext:
        """An integer in every slot, exactly, at scale 1 (ckks.cpp:232-287):
        the constant polynomial ``value``, whose NTT is itself."""
        cd = self._level(self.context.first_parms_id if parms_id is None else parms_id)
        p = Plaintext()
        p.parms_id = cd.parms_id
        p.scale = 1.0
        p.rns_data = _c([value % q for q in cd.coeff_modulus_values], self.context.device).expand(-1, self.n).contiguous()
        return p

    # -- decode ------------------------------------------------------------
    def decode(self, plain: Plaintext) -> np.ndarray:
        """NTT-form plaintext -> the N/2 complex slot values (ckks.h:683-787)."""
        if not plain.is_ntt_form:
            raise ValueError("plain is not in NTT form")
        cd = self._level(plain.parms_id)
        self._check_scale(plain.scale, cd)
        t = cd.limb_tables()
        ops = self._inv_punctured.get(cd.parms_id)
        if ops is None:
            ops = _cshoup(cd.base_q.inv_punctured, cd.coeff_modulus_values, self.context.device)
            self._inv_punctured[cd.parms_id] = ops
        x = NTT.inverse(plain.rns_data, t)
        scaled = U.mul_mod_shoup(x, ops[0], ops[1], t.q)
        res = CC.compose_centered_double(scaled, cd.base_q, 1.0 / plain.scale)
        re, im = SF.fft_to_rev((res, torch.zeros_like(res)), self._roots)
        idx = self.index_map[: self.slot_count]
        out = np.empty(self.slot_count, dtype=np.complex128)
        out.real = re[idx].cpu().numpy()
        out.imag = im[idx].cpu().numpy()
        return out
