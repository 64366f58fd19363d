"""SealContext: parameter validation + per-level precompute + modulus chain.

Port of ``seal_tpu/context.py`` (counterpart of
``native/src/seal/context.{h,cpp}``).  A context is an immutable bundle of
per-level ``ContextData`` linked into the modulus switching chain (drop the
last prime per level, ``context.cpp:462-563``).  Each level carries exact
host constants and lazily built int64 tensors on the context's device.

The device is chosen once, here: ``device=None`` means the card, and a
machine without one raises; ``device="cpu"`` is the only way to run the
plain PyTorch versions on the CPU.  Everything built from the context lives
on its device.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from . import numth
from .modulus import (
    COEFF_MOD_COUNT_MAX,
    COEFF_MOD_COUNT_MIN,
    CoeffModulus,
    Modulus,
    POLY_MOD_DEGREE_MAX,
    POLY_MOD_DEGREE_MIN,
    PLAIN_MOD_BIT_COUNT_MAX,
    PLAIN_MOD_BIT_COUNT_MIN,
    USER_MOD_BIT_COUNT_MAX,
    MOD_BIT_COUNT_MIN,
    SecurityLevel,
)
from .ops.poly import get_elt_from_step, get_elts_all, make_galois_table_coeff, make_galois_table_ntt
from .ntt_tables import HostNTTTables, LimbTables, build_limb_tables, cached_host_ntt_tables
from .params import EncryptionParameters, ParmsId, PARMS_ID_ZERO, SchemeType
from .rns_host import HostRNSBase, HostRNSTool


class ErrorType(enum.Enum):
    """Parameter validation outcomes (cf. ``error_type``, context.h:34-120)."""

    NONE = "none"
    SUCCESS = "success"
    INVALID_SCHEME = "invalid_scheme"
    INVALID_COEFF_MODULUS_SIZE = "invalid_coeff_modulus_size"
    INVALID_COEFF_MODULUS_BIT_COUNT = "invalid_coeff_modulus_bit_count"
    INVALID_COEFF_MODULUS_NO_NTT = "invalid_coeff_modulus_no_ntt"
    INVALID_COEFF_MODULUS_NON_PRIME = "invalid_coeff_modulus_non_prime"
    INVALID_POLY_MODULUS_DEGREE = "invalid_poly_modulus_degree"
    INVALID_POLY_MODULUS_DEGREE_NON_POWER_OF_TWO = "invalid_poly_modulus_degree_non_power_of_two"
    INVALID_PARAMETERS_TOO_LARGE = "invalid_parameters_too_large"
    INVALID_PARAMETERS_INSECURE = "invalid_parameters_insecure"
    FAILED_CREATING_RNS_BASE = "failed_creating_rns_base"
    INVALID_PLAIN_MODULUS_BIT_COUNT = "invalid_plain_modulus_bit_count"
    INVALID_PLAIN_MODULUS_COPRIMALITY = "invalid_plain_modulus_coprimality"
    INVALID_PLAIN_MODULUS_TOO_LARGE = "invalid_plain_modulus_too_large"
    INVALID_PLAIN_MODULUS_NONZERO = "invalid_plain_modulus_nonzero"
    FAILED_CREATING_RNS_TOOL = "failed_creating_rns_tool"


@dataclass
class EncryptionParameterQualifiers:
    """cf. ``EncryptionParameterQualifiers`` (context.h:28-214)."""

    parameter_error: ErrorType = ErrorType.NONE
    using_fft: bool = False
    using_ntt: bool = False
    using_batching: bool = False
    using_fast_plain_lift: bool = False
    using_descending_modulus_chain: bool = False
    sec_level: SecurityLevel = SecurityLevel.NONE

    @property
    def parameters_set(self) -> bool:
        return self.parameter_error == ErrorType.SUCCESS

    @property
    def parameter_error_message(self) -> str:
        return self.parameter_error.value


def resolve_device(device) -> torch.device:
    """The card unless the caller names another device; never a fallback."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the plain "
                "PyTorch versions on the CPU"
            )
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    return device


class GaloisTool:
    """Automorphism helper with cached permutation tables (``util/galois.cpp``).

    The tables are kept once per Galois element as host arrays, and once
    per (element, device) as the tensors the gather takes (the NTT-domain
    index, or the coefficient-domain index and negate flags), so a rotation
    copies no table to the card.
    """

    GENERATOR = 3

    def __init__(self, log_n: int):
        self.log_n = log_n
        self.n = 1 << log_n
        self._ntt_tables: Dict[int, np.ndarray] = {}
        self._coeff_tables: Dict[int, Tuple[np.ndarray, np.ndarray]] = {}
        self._ntt_index: Dict[Tuple[int, torch.device], torch.Tensor] = {}
        self._coeff_index: Dict[Tuple[int, torch.device], Tuple[torch.Tensor, torch.Tensor]] = {}

    def get_elt_from_step(self, step: int) -> int:
        return get_elt_from_step(step, self.n)

    def get_elts_from_steps(self, steps: Sequence[int]) -> List[int]:
        return [self.get_elt_from_step(s) for s in steps]

    def get_elts_all(self) -> List[int]:
        return get_elts_all(self.n)

    @staticmethod
    def get_index_from_elt(galois_elt: int) -> int:
        return (galois_elt - 1) >> 1

    def ntt_table(self, galois_elt: int) -> np.ndarray:
        if galois_elt not in self._ntt_tables:
            self._ntt_tables[galois_elt] = make_galois_table_ntt(self.n, galois_elt)
        return self._ntt_tables[galois_elt]

    def coeff_table(self, galois_elt: int) -> Tuple[np.ndarray, np.ndarray]:
        if galois_elt not in self._coeff_tables:
            self._coeff_tables[galois_elt] = make_galois_table_coeff(self.n, galois_elt)
        return self._coeff_tables[galois_elt]

    def ntt_index(self, galois_elt: int, device) -> torch.Tensor:
        """The NTT-domain table as an int64 index tensor on ``device``."""
        key = (galois_elt, torch.device(device))
        if key not in self._ntt_index:
            self._ntt_index[key] = torch.from_numpy(self.ntt_table(galois_elt).astype(np.int64)).to(key[1])
        return self._ntt_index[key]

    def coeff_index(self, galois_elt: int, device) -> Tuple[torch.Tensor, torch.Tensor]:
        """The coefficient-domain table on ``device``: (source index int64,
        negate flag bool)."""
        key = (galois_elt, torch.device(device))
        if key not in self._coeff_index:
            src, neg = self.coeff_table(galois_elt)
            self._coeff_index[key] = (torch.from_numpy(src.astype(np.int64)).to(key[1]),
                                      torch.from_numpy(neg).to(key[1]))
        return self._coeff_index[key]


class ContextData:
    """Per-level immutable precompute bundle (cf. ``SEALContext::ContextData``)."""

    def __init__(self, parms: EncryptionParameters, device: torch.device):
        self.parms = parms
        self.device = device
        self.qualifiers = EncryptionParameterQualifiers()
        self.prev_context_data: Optional["ContextData"] = None
        self.next_context_data: Optional["ContextData"] = None
        self.chain_index = 0

        self.total_coeff_modulus: int = 1
        self.base_q: Optional[HostRNSBase] = None
        self.ntt_tables: List[HostNTTTables] = []
        self.plain_ntt_tables: Optional[HostNTTTables] = None
        self.rns_tool: Optional[HostRNSTool] = None
        self.galois_tool: Optional[GaloisTool] = None
        # BFV and BGV: Delta = floor(q/t) and q mod t, in RNS and whole
        self.coeff_div_plain_modulus: List[int] = []
        self.upper_half_increment: List[int] = []
        self.coeff_modulus_mod_plain_modulus: int = 0
        # the lift of a coefficient plaintext into base q (context.cpp:332-404)
        self.plain_upper_half_threshold: int = 0
        self.plain_upper_half_increment: List[int] = []
        self.upper_half_threshold: int = 0
        self._limb_tables: Dict[Tuple[str, torch.device], LimbTables] = {}

    @property
    def parms_id(self) -> ParmsId:
        return self.parms.parms_id

    @property
    def total_coeff_modulus_bit_count(self) -> int:
        return self.total_coeff_modulus.bit_length()

    @property
    def coeff_modulus_values(self) -> List[int]:
        return [m.value for m in self.parms.coeff_modulus]

    @property
    def log_n(self) -> int:
        return self.parms.poly_modulus_degree.bit_length() - 1

    def _cached_tables(self, name: str, device, build) -> LimbTables:
        device = self.device if device is None else torch.device(device)
        tables = self._limb_tables.get((name, device))
        if tables is None:
            tables = self._limb_tables[(name, device)] = build(device)
        return tables

    def limb_tables(self, device=None) -> LimbTables:
        """NTT + modulus constants for base q at this level, on the context's
        device or, for a rank of a mesh, on ``device``; built once per device."""
        return self._cached_tables("q", device, lambda dev: build_limb_tables(
            self.log_n, self.parms.coeff_modulus, self.ntt_tables, device=dev))

    def behz_limb_tables(self, device=None) -> LimbTables:
        """The BFV multiply's tables over q U Bsk (q's limbs first), with the
        plain modulus t folded into the inverse transform's 1/n constants:
        the BEHZ multiply scales every inverse NTT output by t
        (evaluator.cpp:549), so the scaling costs nothing.  The forward
        tables are the plain ones (``inv_scale`` touches only the inverse),
        so one bundle serves the forward transform of both bases and the
        t-scaled inverse of both, one launch each.  Built once per device,
        under its own key beside the unscaled tables of q."""
        moduli = list(self.parms.coeff_modulus) + list(self.rns_tool.base_Bsk.moduli)
        return self._cached_tables("behz", device, lambda dev: build_limb_tables(
            self.log_n, moduli, inv_scale=[self.parms.plain_modulus.value] * len(moduli), device=dev))


class SealContext:
    """Validated parameter chain (cf. ``SEALContext``, context.cpp:495-563)."""

    def __init__(
        self,
        parms: EncryptionParameters,
        expand_mod_chain: bool = True,
        sec_level: SecurityLevel = SecurityLevel.TC128,
        device=None,
    ):
        self.device = resolve_device(device)
        self.sec_level = sec_level
        parms = parms.clone()
        self._context_data_map: Dict[ParmsId, ContextData] = {}

        key_cd = self._validate(parms)
        self._context_data_map[parms.parms_id] = key_cd
        self.key_parms_id = parms.parms_id

        if not key_cd.qualifiers.parameters_set or len(parms.coeff_modulus) == 1:
            self.first_parms_id = self.key_parms_id
        else:
            next_id = self._create_next_context_data(self.key_parms_id)
            self.first_parms_id = self.key_parms_id if next_id == PARMS_ID_ZERO else next_id

        self.last_parms_id = self.first_parms_id
        self.using_keyswitching = self.first_parms_id != self.key_parms_id

        if expand_mod_chain and self._context_data_map[self.first_parms_id].qualifiers.parameters_set:
            prev = self.first_parms_id
            while len(self._context_data_map[prev].parms.coeff_modulus) > 1:
                next_id = self._create_next_context_data(prev)
                if next_id == PARMS_ID_ZERO:
                    break
                prev = next_id
                self.last_parms_id = next_id

        count = len(self._context_data_map)
        cd: Optional[ContextData] = self._context_data_map[self.key_parms_id]
        while cd is not None:
            count -= 1
            cd.chain_index = count
            cd = cd.next_context_data

    def _create_next_context_data(self, prev_id: ParmsId) -> ParmsId:
        prev = self._context_data_map[prev_id]
        next_parms = prev.parms.clone()
        next_parms.set_coeff_modulus(next_parms.coeff_modulus[:-1])
        cd = self._validate(next_parms)
        if not cd.qualifiers.parameters_set:
            return PARMS_ID_ZERO
        self._context_data_map[next_parms.parms_id] = cd
        prev.next_context_data = cd
        cd.prev_context_data = prev
        return next_parms.parms_id

    def get_context_data(self, parms_id: ParmsId) -> Optional[ContextData]:
        return self._context_data_map.get(tuple(parms_id))

    def key_context_data(self) -> ContextData:
        return self._context_data_map[self.key_parms_id]

    def first_context_data(self) -> ContextData:
        return self._context_data_map[self.first_parms_id]

    def last_context_data(self) -> ContextData:
        return self._context_data_map[self.last_parms_id]

    @property
    def parameters_set(self) -> bool:
        return self.first_context_data().qualifiers.parameters_set

    def parameter_error_name(self) -> str:
        return self.key_context_data().qualifiers.parameter_error.name

    def parameter_error_message(self) -> str:
        return self.key_context_data().qualifiers.parameter_error_message

    # -- validation (context.cpp:142-460) ---------------------------------
    def _validate(self, parms: EncryptionParameters) -> ContextData:
        cd = ContextData(parms, self.device)
        q = cd.qualifiers
        q.parameter_error = ErrorType.SUCCESS

        if parms.scheme == SchemeType.NONE:
            q.parameter_error = ErrorType.INVALID_SCHEME
            return cd

        coeff_modulus = parms.coeff_modulus
        plain_modulus = parms.plain_modulus

        if not (COEFF_MOD_COUNT_MIN <= len(coeff_modulus) <= COEFF_MOD_COUNT_MAX):
            q.parameter_error = ErrorType.INVALID_COEFF_MODULUS_SIZE
            return cd

        for m in coeff_modulus:
            if m.value >> USER_MOD_BIT_COUNT_MAX or not (m.value >> (MOD_BIT_COUNT_MIN - 1)):
                q.parameter_error = ErrorType.INVALID_COEFF_MODULUS_BIT_COUNT
                return cd
            if not m.is_prime:
                q.parameter_error = ErrorType.INVALID_COEFF_MODULUS_NON_PRIME
                return cd

        cd.total_coeff_modulus = 1
        for m in coeff_modulus:
            cd.total_coeff_modulus *= m.value

        n = parms.poly_modulus_degree
        if not (POLY_MOD_DEGREE_MIN <= n <= POLY_MOD_DEGREE_MAX):
            q.parameter_error = ErrorType.INVALID_POLY_MODULUS_DEGREE
            return cd
        log_n = n.bit_length() - 1
        if (1 << log_n) != n:
            q.parameter_error = ErrorType.INVALID_POLY_MODULUS_DEGREE_NON_POWER_OF_TWO
            return cd

        q.using_fft = True
        q.sec_level = self.sec_level
        if cd.total_coeff_modulus_bit_count > CoeffModulus.max_bit_count(n, self.sec_level):
            q.sec_level = SecurityLevel.NONE
            if self.sec_level != SecurityLevel.NONE:
                q.parameter_error = ErrorType.INVALID_PARAMETERS_INSECURE
                return cd

        try:
            cd.base_q = HostRNSBase(coeff_modulus)
        except ValueError:
            q.parameter_error = ErrorType.FAILED_CREATING_RNS_BASE
            return cd

        q.using_ntt = True
        try:
            cd.ntt_tables = [cached_host_ntt_tables(log_n, m) for m in coeff_modulus]
        except (ValueError, RuntimeError):
            q.using_ntt = False
            q.parameter_error = ErrorType.INVALID_COEFF_MODULUS_NO_NTT
            return cd

        if parms.scheme in (SchemeType.BFV, SchemeType.BGV):
            t = plain_modulus.value
            if t >> PLAIN_MOD_BIT_COUNT_MAX or not (t >> (PLAIN_MOD_BIT_COUNT_MIN - 1)):
                q.parameter_error = ErrorType.INVALID_PLAIN_MODULUS_BIT_COUNT
                return cd
            for m in coeff_modulus:
                if numth.gcd(m.value, t) != 1:
                    q.parameter_error = ErrorType.INVALID_PLAIN_MODULUS_COPRIMALITY
                    return cd
            if t >= cd.total_coeff_modulus:
                q.parameter_error = ErrorType.INVALID_PLAIN_MODULUS_TOO_LARGE
                return cd
            # batching needs the mod-t NTT: t prime and 1 mod 2N
            q.using_batching = True
            try:
                cd.plain_ntt_tables = cached_host_ntt_tables(log_n, plain_modulus)
            except (ValueError, RuntimeError):
                q.using_batching = False
            q.using_fast_plain_lift = all(m.value > t for m in coeff_modulus)
            # Delta = floor(q/t) and q mod t (context.cpp:332-376)
            delta, rem = divmod(cd.total_coeff_modulus, t)
            cd.coeff_div_plain_modulus = cd.base_q.decompose(delta)
            cd.upper_half_increment = cd.base_q.decompose(rem)
            cd.coeff_modulus_mod_plain_modulus = rem
            cd.plain_upper_half_threshold = (t + 1) >> 1
            if q.using_fast_plain_lift:
                cd.plain_upper_half_increment = [m.value - t for m in coeff_modulus]
            else:
                cd.plain_upper_half_increment = cd.base_q.decompose(cd.total_coeff_modulus - t)
        elif parms.scheme == SchemeType.CKKS:
            if not plain_modulus.is_zero:
                q.parameter_error = ErrorType.INVALID_PLAIN_MODULUS_NONZERO
                return cd
            q.using_batching = True
            q.using_fast_plain_lift = False
            cd.plain_upper_half_threshold = 1 << 63
            # plain_upper_half_increment_i = (-2^64) mod q_i (context.cpp:395-404)
            cd.plain_upper_half_increment = [
                ((1 << 63) % m.value) * (m.value - 2) % m.value for m in coeff_modulus
            ]
            cd.upper_half_threshold = (cd.total_coeff_modulus + 1) >> 1
        else:
            q.parameter_error = ErrorType.INVALID_SCHEME
            return cd

        try:
            cd.rns_tool = HostRNSTool(n, cd.base_q, plain_modulus if parms.scheme != SchemeType.CKKS else Modulus(0))
        except (ValueError, RuntimeError):
            q.parameter_error = ErrorType.FAILED_CREATING_RNS_TOOL
            return cd

        q.using_descending_modulus_chain = all(
            coeff_modulus[i].value > coeff_modulus[i + 1].value for i in range(len(coeff_modulus) - 1)
        )
        cd.galois_tool = GaloisTool(log_n)
        return cd
