"""Serialization: Microsoft SEAL's wire format for every object.

Port of ``seal_tpu/serialization.py`` (counterpart of
``serialization.{h,cpp}`` and each object's ``save_members``): a 16-byte
SEALHeader (magic 0xA15E, header size, version, compression mode, total
size) before the members, which may be compressed.  The formats follow the
reference byte for byte (little-endian), nested header-wrapped members
included (each Modulus of the EncryptionParameters, the DynArray of a
Plaintext or Ciphertext), and a seeded ciphertext stores c0 and the seed of
c1, which a load expands with the sampler of the blob's version.

Compression: zlib from the standard library, Zstandard where the
``zstandard`` module imports (the reference's CMake options gate it the same
way); a decompressed size is bounded by ``MAX_DECOMPRESSED_SIZE``
(ztools.cpp, CHANGES v4.3.3).

A load parses, checks sizes and reshapes on the host in numpy, checks the
metadata against the context, and only then copies the data to the
context's device, once per object; malformed input raises ``ValueError``.
A save reads each tensor back from the device once.
"""

from __future__ import annotations

import functools
import io
import struct
import zlib
from typing import Optional, Tuple

import numpy as np

from .convert import u64_from_numpy, u64_to_numpy
from .data import Ciphertext, KSwitchKeys, Plaintext, PublicKey, SecretKey
from .modulus import Modulus
from .params import PARMS_ID_ZERO, EncryptionParameters, SchemeType
from .random.prng import UniformRandomGeneratorInfo
from .random.sampler import sample_poly_uniform, sample_poly_uniform_seal_3_4, sample_poly_uniform_seal_3_5
from .valcheck import is_metadata_valid_ct

SEAL_MAGIC = 0xA15E
SEAL_HEADER_SIZE = 0x10
VERSION_MAJOR = 4
VERSION_MINOR = 4

COMPR_NONE = 0
COMPR_ZLIB = 1
COMPR_ZSTD = 2

try:  # the optional Zstandard backend
    import zstandard as _zstd  # type: ignore

    _HAS_ZSTD = True
except Exception:
    _zstd = None
    _HAS_ZSTD = False

COMPR_MODE_DEFAULT = COMPR_ZSTD if _HAS_ZSTD else COMPR_ZLIB

# bound on a decompressed payload (decompression bombs)
MAX_DECOMPRESSED_SIZE = 1 << 32

_HEADER = struct.Struct("<HBBBBHQ")          # magic, size, major, minor, compr, reserved, total size
_HEADER_3_4 = struct.Struct("<HBBIQ")        # magic, zero, compr, total size, reserved
_COMPR_MODES = (COMPR_NONE, COMPR_ZLIB, COMPR_ZSTD)


def _compress(data: bytes, mode: int) -> bytes:
    if mode == COMPR_NONE:
        return data
    if mode == COMPR_ZLIB:
        return zlib.compress(data, 6)
    if mode == COMPR_ZSTD:
        if not _HAS_ZSTD:
            raise ValueError("zstd compression mode is not supported in this build")
        return _zstd.ZstdCompressor().compress(data)
    raise ValueError("unsupported compression mode")


def _decompress(data: bytes, mode: int) -> bytes:
    if mode == COMPR_NONE:
        return data
    if mode == COMPR_ZLIB:
        try:
            d = zlib.decompressobj()
            out = d.decompress(data, MAX_DECOMPRESSED_SIZE)
        except zlib.error as e:
            raise ValueError(f"corrupted zlib stream: {e}") from e
        if d.unconsumed_tail:
            raise ValueError("decompressed size exceeds safety bound")
        return out
    if mode == COMPR_ZSTD:
        if not _HAS_ZSTD:
            raise ValueError("zstd compression mode is not supported in this build")
        try:
            return _zstd.ZstdDecompressor().decompress(data, max_output_size=MAX_DECOMPRESSED_SIZE)
        except _zstd.ZstdError as e:
            raise ValueError(f"corrupted zstd stream: {e}") from e
    raise ValueError("unsupported compression mode")


def _load_guard(fn):
    """A loader fails with ValueError, never with the struct.error or
    IndexError of a malformed blob (CHANGES v4.4.0)."""

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        try:
            return fn(*args, **kwargs)
        except (struct.error, IndexError) as e:
            raise ValueError(f"malformed serialized data: {e}") from e

    return wrapped


def save_header_wrapped(members: bytes, compr_mode: int = None) -> bytes:
    """Members behind a SEALHeader (Serialization::Save)."""
    if compr_mode is None:
        compr_mode = COMPR_MODE_DEFAULT
    payload = _compress(members, compr_mode)
    header = _HEADER.pack(SEAL_MAGIC, SEAL_HEADER_SIZE, VERSION_MAJOR, VERSION_MINOR, compr_mode, 0,
                          SEAL_HEADER_SIZE + len(payload))
    return header + payload


def _is_modern(hsize: int, vmaj: int, compr: int) -> bool:
    return hsize == SEAL_HEADER_SIZE and vmaj in (VERSION_MAJOR, 3) and compr in _COMPR_MODES


def _legacy_3_4(data: bytes) -> Optional[Tuple[int, int]]:
    """(compression mode, size) of a valid Microsoft SEAL 3.4 header
    (serialization.h:352-377), else None."""
    _, zero, compr, size, _ = _HEADER_3_4.unpack_from(data, 0)
    if zero == 0 and compr in _COMPR_MODES and size >= SEAL_HEADER_SIZE:
        return compr, size
    return None


def peek_version(data: bytes) -> Tuple[int, int]:
    """(major, minor) of a blob's SEALHeader.  A header that fails the
    modern checks but reads in the 3.4 layout, which has no version field,
    is (3, 4), as the reference's header upgrade has it
    (serialization.cpp:138-168)."""
    if len(data) < SEAL_HEADER_SIZE:
        raise ValueError("insufficient data for SEALHeader")
    _, hsize, vmaj, vmin, compr, _, _ = _HEADER.unpack_from(data, 0)
    if not _is_modern(hsize, vmaj, compr) and _legacy_3_4(data) is not None:
        return 3, 4
    return vmaj, vmin


def load_header_wrapped(data: bytes) -> Tuple[bytes, int]:
    """The members behind a SEALHeader, decompressed, and the bytes the
    object took.  A header that fails the modern checks is read in the 3.4
    layout and taken if valid there (``Serialization::LoadHeader`` with
    try_upgrade_if_invalid, serialization.cpp:138-168)."""
    if len(data) < SEAL_HEADER_SIZE:
        raise ValueError("insufficient data for SEALHeader")
    magic, hsize, vmaj, _, compr, _, size = _HEADER.unpack_from(data, 0)
    if magic != SEAL_MAGIC:
        raise ValueError("invalid SEAL magic")
    if not _is_modern(hsize, vmaj, compr):
        legacy = _legacy_3_4(data)
        if legacy is not None:
            compr, size = legacy
        elif hsize != SEAL_HEADER_SIZE:
            raise ValueError("invalid SEALHeader size")
        else:
            raise ValueError("unsupported version")
    if size > len(data):
        raise ValueError("truncated payload")
    return _decompress(bytes(data[SEAL_HEADER_SIZE:size]), compr), size


# ---------------------------------------------------------------------------
# leaf members
# ---------------------------------------------------------------------------

def modulus_save(value: int, compr_mode: int = COMPR_NONE) -> bytes:
    return save_header_wrapped(struct.pack("<Q", value), compr_mode)


@_load_guard
def modulus_load(data: bytes) -> Tuple[int, int]:
    members, consumed = load_header_wrapped(data)
    (value,) = struct.unpack_from("<Q", members, 0)
    return value, consumed


def dynarray_save(arr: np.ndarray, compr_mode: int = COMPR_NONE) -> bytes:
    a = np.ascontiguousarray(arr, dtype="<u8")
    return save_header_wrapped(struct.pack("<Q", a.size) + a.tobytes(), compr_mode)


@_load_guard
def dynarray_load(data: bytes, max_size: Optional[int] = None) -> Tuple[np.ndarray, int]:
    members, consumed = load_header_wrapped(data)
    (size,) = struct.unpack_from("<Q", members, 0)
    if max_size is not None and size > max_size:
        raise ValueError("DynArray size exceeds expected maximum")
    return np.frombuffer(members, dtype="<u8", count=size, offset=8).copy(), consumed


# ---------------------------------------------------------------------------
# EncryptionParameters
# ---------------------------------------------------------------------------

def params_save(parms: EncryptionParameters, compr_mode: int = None) -> bytes:
    body = io.BytesIO()
    body.write(struct.pack("<BQQ", int(parms.scheme), parms.poly_modulus_degree, len(parms.coeff_modulus)))
    for m in parms.coeff_modulus:
        body.write(modulus_save(m.value))
    body.write(modulus_save(parms.plain_modulus.value))
    return save_header_wrapped(body.getvalue(), compr_mode)


@_load_guard
def params_load(data: bytes) -> Tuple[EncryptionParameters, int]:
    members, consumed = load_header_wrapped(data)
    scheme, degree, k = struct.unpack_from("<BQQ", members, 0)
    off = 17
    coeffs = []
    for _ in range(k):
        v, used = modulus_load(members[off:])
        coeffs.append(Modulus(v))
        off += used
    t, used = modulus_load(members[off:])
    parms = EncryptionParameters(SchemeType(scheme))
    if degree:
        parms.set_poly_modulus_degree(degree)
    if coeffs:
        parms.set_coeff_modulus(coeffs)
    if SchemeType(scheme) in (SchemeType.BFV, SchemeType.BGV) and t:
        parms.set_plain_modulus(t)
    return parms, consumed


# ---------------------------------------------------------------------------
# Plaintext / Ciphertext
# ---------------------------------------------------------------------------

def plaintext_save(plain: Plaintext, compr_mode: int = None) -> bytes:
    if plain.is_ntt_form:
        data = u64_to_numpy(plain.rns_data).reshape(-1)
    else:
        data = np.asarray(plain.coeff_data, dtype=np.uint64)
    body = struct.pack("<4QQd", *plain.parms_id, data.size, plain.scale) + dynarray_save(data)
    return save_header_wrapped(body, compr_mode)


@_load_guard
def plaintext_load(data: bytes, context) -> Tuple[Plaintext, int]:
    members, consumed = load_header_wrapped(data)
    *parms_id, coeff_count, scale = struct.unpack_from("<4QQd", members, 0)
    arr, _ = dynarray_load(members[48:], max_size=coeff_count)
    p = Plaintext()
    p.scale = scale
    p.parms_id = tuple(parms_id)
    if p.parms_id != PARMS_ID_ZERO:
        cd = context.get_context_data(p.parms_id)
        if cd is None:
            raise ValueError("plaintext parms_id is invalid for context")
        p.rns_data = u64_from_numpy(arr.reshape(len(cd.parms.coeff_modulus), cd.parms.poly_modulus_degree),
                                    context.device)
    else:
        p.coeff_data = arr
    return p, consumed


_CT_HEAD = struct.Struct("<4QBQQQd")          # parms_id, ntt flag, size, degree, k, scale


def _ciphertext_members(parms_id, is_ntt_form: bool, size: int, k: int, n: int, scale: float,
                        correction_factor: int, data: np.ndarray, seed_info) -> bytes:
    """A ciphertext's members: ``data`` is all of it, (size, k, n), or for
    a seeded one c0, (k, n), with the seed of c1."""
    head = _CT_HEAD.pack(*parms_id, 1 if is_ntt_form else 0, size, n, k, scale)
    head += struct.pack("<Q", correction_factor)
    body = dynarray_save(data.reshape(-1))
    if seed_info is not None:
        body += save_header_wrapped(seed_info.save_members(), COMPR_NONE)
    return head + body


def ciphertext_save(ct: Ciphertext, compr_mode: int = None) -> bytes:
    """Save a ciphertext; a seeded one stores c0 and the seed of c1."""
    data = u64_to_numpy(ct.data[0] if ct.seed_info is not None else ct.data)
    members = _ciphertext_members(ct.parms_id, ct.is_ntt_form, ct.size, ct.coeff_modulus_size,
                                  ct.poly_modulus_degree, ct.scale, ct.correction_factor, data, ct.seed_info)
    return save_header_wrapped(members, compr_mode)


def _expand_seeded(version: Tuple[int, int], info_members: bytes, n: int, moduli) -> np.ndarray:
    """c1 of a seeded ciphertext: the raw uniform stream over the level's
    moduli, whatever the NTT flag (the reference samples it in the form the
    ciphertext is in, rlwe.cpp:310-330), by the sampler of the blob's
    version (ciphertext.cpp:118-151 expand_seed)."""
    prng = UniformRandomGeneratorInfo.load_members(info_members).make_prng()
    if prng is None:
        raise ValueError("unknown prng type")
    vmaj, vmin = version
    if vmaj == 4 or (vmaj == 3 and vmin >= 6):
        expand = sample_poly_uniform
    elif version == (3, 4):
        expand = sample_poly_uniform_seal_3_4
    elif version == (3, 5):
        expand = sample_poly_uniform_seal_3_5
    else:
        # before 3.4 the seed drove AES-128 (ciphertext.cpp:146-150)
        raise ValueError("incompatible version")
    return expand(prng, n, moduli)


def _ciphertext_load_host(data: bytes, context) -> Tuple[Ciphertext, np.ndarray, int]:
    """A ciphertext's metadata (``data`` left None), its (size, k, n) uint64
    data on the host, and the bytes it took."""
    version = peek_version(data)
    members, consumed = load_header_wrapped(data)
    members = memoryview(members)           # nested members are read in place, not copied
    *parms_id, ntt_byte, size, degree, k, scale = _CT_HEAD.unpack_from(members, 0)
    parms_id = tuple(parms_id)
    off = _CT_HEAD.size
    correction = 1
    if version[0] == 4:
        # correction_factor arrived in 4.x (ciphertext.cpp load_members)
        (correction,) = struct.unpack_from("<Q", members, off)
        off += 8
    ct = Ciphertext(parms_id=parms_id, is_ntt_form=bool(ntt_byte), scale=scale, correction_factor=correction)
    if not is_metadata_valid_ct(context, parms_id, size, degree, k, allow_key_level=True):
        raise ValueError("ciphertext data is invalid")
    arr, used = dynarray_load(members[off:], max_size=size * degree * k)
    off += used
    if arr.size == degree * k:
        if size != 2:
            raise ValueError("ciphertext data is invalid")
        info_members, _ = load_header_wrapped(members[off:])
        c1 = _expand_seeded(version, info_members, degree, context.get_context_data(parms_id).coeff_modulus_values)
        full = np.stack([arr.reshape(k, degree), c1])
    elif arr.size == size * degree * k:
        full = arr.reshape(size, k, degree)
    else:
        raise ValueError("ciphertext data is invalid")
    return ct, full, consumed


@_load_guard
def ciphertext_load(data: bytes, context) -> Tuple[Ciphertext, int]:
    """A ciphertext on the context's device; a seeded blob comes back
    expanded, with ``seed_info`` None."""
    ct, full, consumed = _ciphertext_load_host(data, context)
    ct.data = u64_from_numpy(full, context.device)
    return ct, consumed


# ---------------------------------------------------------------------------
# keys
# ---------------------------------------------------------------------------

def secret_key_save(sk: SecretKey, compr_mode: int = None) -> bytes:
    p = Plaintext()
    p.parms_id = sk.parms_id
    p.rns_data = sk.data
    return plaintext_save(p, compr_mode)


@_load_guard
def secret_key_load(data: bytes, context) -> Tuple[SecretKey, int]:
    p, consumed = plaintext_load(data, context)
    return SecretKey(p.rns_data, p.parms_id), consumed


def public_key_save(pk: PublicKey, compr_mode: int = None) -> bytes:
    return ciphertext_save(pk.data, compr_mode)


@_load_guard
def public_key_load(data: bytes, context) -> Tuple[PublicKey, int]:
    ct, consumed = ciphertext_load(data, context)
    return PublicKey(ct), consumed


def kswitch_keys_save(keys: KSwitchKeys, context, compr_mode: int = None) -> bytes:
    """parms_id, the number of entries, then per entry its count D and D
    public keys (None: a count of 0).  A key made with ``save_seed`` stores
    c0 and the seed of each c1 (Serializable<RelinKeys/GaloisKeys>)."""
    body = io.BytesIO()
    body.write(struct.pack("<4QQ", *keys.parms_id, len(keys.keys)))
    for entry in keys.keys:
        if entry is None:
            body.write(struct.pack("<Q", 0))
            continue
        seeds = entry.get("seeds")
        c0 = u64_to_numpy(entry["c0"])                          # (D, k_key, n)
        c1 = None if seeds is not None and all(s is not None for s in seeds) else u64_to_numpy(entry["c1"])
        D, k, n = c0.shape
        body.write(struct.pack("<Q", D))
        for j in range(D):
            seed = None if seeds is None else seeds[j]
            data = c0[j] if seed is not None else np.stack([c0[j], c1[j]])
            body.write(save_header_wrapped(
                _ciphertext_members(keys.parms_id, True, 2, k, n, 1.0, 1, data, seed), COMPR_NONE))
    return save_header_wrapped(body.getvalue(), compr_mode)


@_load_guard
def kswitch_keys_load(data: bytes, context, cls=None) -> Tuple[KSwitchKeys, int]:
    """Keys on the context's device, one copy per entry; ``seeds`` None."""
    members, consumed = load_header_wrapped(data)
    members = memoryview(members)
    *parms_id, dim1 = struct.unpack_from("<4QQ", members, 0)
    off = 40
    keys = (cls or KSwitchKeys)()
    keys.parms_id = tuple(parms_id)
    keys.keys = []
    for _ in range(dim1):
        (dim2,) = struct.unpack_from("<Q", members, off)
        off += 8
        if dim2 == 0:
            keys.keys.append(None)
            continue
        c0s, c1s = [], []
        for _ in range(dim2):
            _, full, used = _ciphertext_load_host(members[off:], context)
            off += used
            c0s.append(full[0])
            c1s.append(full[1])
        keys.keys.append({"c0": u64_from_numpy(np.stack(c0s), context.device),
                          "c1": u64_from_numpy(np.stack(c1s), context.device), "seeds": None})
    return keys, consumed
