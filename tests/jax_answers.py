"""Frozen answers of the JAX package for the port's parity tests.

The JAX package is the reference and does not change, so with fixed seeds
its answers are constants.  A parity test that reads them here computes only
the port's side: it builds its inputs with the port's own client from the
same seeds, checks their digest against the record (a drift reads "inputs
differ"), then checks the digest of its outputs ("outputs differ").

``tests/data/jax_answers/<test file stem>.json`` maps each case's pytest id
to ``{"inputs": {name: digest}, "outputs": {name: digest}}``.  A converted
test file defines ``answers(side)``, which yields ``(case id, inputs,
outputs)`` for every recorded case from the JAX package (``side="jax"``)
or the port (``side="port"``), and one test marked ``slow`` that calls
:func:`check_twin`: it recomputes the JAX side of every case, holds it to
the record, and holds it to the port word by word, so a drift there names
the first differing index.  ``python tools/freeze_jax_answers.py`` writes
the records from the JAX side.

A digest is the SHA-256 of the uint64 words (little-endian) followed by the
metadata words: parms_id, NTT form, scale (its IEEE-754 bits), correction
factor, size.  With no metadata it is ``seal_tpu_torch.golden.digest``.
"""

from __future__ import annotations

import hashlib
import json
import pathlib
import struct

import numpy as np
import pytest

DATA = pathlib.Path(__file__).resolve().parent / "data" / "jax_answers"
MASK = (1 << 64) - 1


def words(x) -> np.ndarray:
    """The uint64 words of a numpy array, a torch tensor, a sharded tensor,
    the JAX package's (lo, hi) pair, bytes, or a float array (its bits)."""
    if isinstance(x, (bytes, bytearray)):
        return np.frombuffer(bytes(x) + b"\0" * (-len(x) % 8), dtype="<u8")
    if isinstance(x, tuple) and len(x) == 2:                      # the JAX package's (lo, hi) u32 pair
        from seal_tpu.ops import u64 as JU
        return JU.to_np_u64(x).ravel()
    if hasattr(x, "unshard"):
        x = x.unshard()
    if hasattr(x, "detach"):                                    # a torch tensor: int64 holding u64 bits
        x = x.detach().cpu().contiguous().numpy()
    a = np.ascontiguousarray(np.asarray(x))
    if a.dtype.kind == "c":
        a = a.astype(np.complex128).view(np.float64)
    if a.dtype.kind == "f":
        return a.astype(np.float64).view(np.uint64).ravel()
    if a.dtype.kind == "i":
        return a.astype(np.int64).view(np.uint64).ravel()
    return a.astype(np.uint64).ravel()


def _meta_words(m) -> list:
    if isinstance(m, (tuple, list)):
        return [w for v in m for w in _meta_words(v)]
    if isinstance(m, (bool, np.bool_)):
        return [int(m)]
    if isinstance(m, (float, np.floating)):
        return [struct.unpack("<Q", struct.pack("<d", float(m)))[0]]
    if isinstance(m, str):
        return list(words(m.encode()))
    return [int(m) & MASK]


def digest(x, *metadata) -> str:
    """SHA-256 of ``x``'s uint64 words, little-endian, then the metadata's."""
    h = hashlib.sha256(np.ascontiguousarray(words(x), dtype="<u8").tobytes())
    if metadata:
        h.update(np.asarray(_meta_words(list(metadata)), dtype="<u8").tobytes())
    return h.hexdigest()


def canon(obj):
    """(words, metadata) of a value of either package: a ciphertext or a
    batch (data; parms_id, NTT form, scale, correction factor, size), a
    plaintext (residues or coefficients; parms_id, NTT form, scale), a
    secret or public key, key-switching keys (every present key's index and
    words; parms_id), a scalar or a message, or anything :func:`words`
    reads."""
    if isinstance(obj, (bool, int, float, str, np.integer, np.floating)):
        return np.zeros(0, dtype=np.uint64), (obj,)
    if hasattr(obj, "keys") and isinstance(getattr(obj, "keys"), list):   # RelinKeys, GaloisKeys
        parts = []
        for i, k in enumerate(obj.keys):
            if k is not None:
                parts += [np.array([i], dtype=np.uint64), words(k["c0"]), words(k["c1"])]
        return (np.concatenate(parts) if parts else np.zeros(0, np.uint64)), (obj.parms_id,)
    if hasattr(obj, "rns_data") and hasattr(obj, "coeff_data"):          # Plaintext
        data = obj.rns_data if obj.is_ntt_form else obj.coeff_data
        return words(data), (obj.parms_id, obj.is_ntt_form, obj.scale)
    data = getattr(obj, "data", None)
    if data is not None and hasattr(data, "is_ntt_form"):                 # PublicKey
        return canon(data)
    if data is not None and hasattr(obj, "is_ntt_form"):                  # Ciphertext, CiphertextBatch
        return words(data), (obj.parms_id, obj.is_ntt_form, obj.scale, obj.correction_factor, obj.size)
    if data is not None and hasattr(obj, "parms_id"):                     # SecretKey
        return words(data), (obj.parms_id,)
    return words(obj), ()


def digest_of(obj) -> str:
    w, meta = canon(obj)
    return digest(w, *meta)


def _path(test_file) -> pathlib.Path:
    return DATA / f"{pathlib.Path(test_file).stem}.json"


def load(test_file) -> dict:
    path = _path(test_file)
    return json.loads(path.read_text()) if path.exists() else {}


def record(test_file, cases) -> int:
    """Write the digests of ``(case id, inputs, outputs)`` for every case;
    returns how many."""
    out = {case: {"inputs": {k: digest_of(v) for k, v in inputs.items()},
                  "outputs": {k: digest_of(v) for k, v in outputs.items()}}
           for case, inputs, outputs in cases}
    DATA.mkdir(parents=True, exist_ok=True)
    _path(test_file).write_text(json.dumps(out, indent=1, sort_keys=True) + "\n")
    return len(out)


def _differing(recorded: dict, values: dict) -> list:
    got = {k: digest_of(v) for k, v in values.items()}
    return sorted(k for k in set(recorded) | set(got) if recorded.get(k) != got.get(k))


class Answers:
    """The records of one test file, read once."""

    def __init__(self, test_file):
        self.test_file = test_file
        self._records = None

    @property
    def records(self) -> dict:
        if self._records is None:
            self._records = load(self.test_file)
        return self._records

    def check(self, case: str, inputs: dict, outputs: dict):
        rec = self.records.get(case)
        if rec is None:
            pytest.fail(f"{case}: no frozen JAX answer in {_path(self.test_file).name}; "
                        f"run tools/freeze_jax_answers.py {pathlib.Path(self.test_file).stem}", pytrace=False)
        bad = _differing(rec["inputs"], inputs)
        assert not bad, f"{case}: inputs differ from the JAX package's: {bad}"
        bad = _differing(rec["outputs"], outputs)
        assert not bad, f"{case}: outputs differ from the JAX package's: {bad}"


def _assert_same(case: str, name: str, jax_value, port_value):
    jw, jm = canon(jax_value)
    pw, pm = canon(port_value)
    np.testing.assert_array_equal(pw, jw, err_msg=f"{case}: {name}")
    assert _meta_words(list(pm)) == _meta_words(list(jm)), f"{case}: {name}: metadata {pm} != {jm}"


def check_twin(test_file, jax_cases, port_cases):
    """The ``slow`` twin: every recorded case recomputed from the JAX package
    equals its record, and equals the port's value word for word."""
    records = load(test_file)
    seen = []
    for (case, jin, jout), (pcase, pin, pout) in zip(jax_cases, port_cases):
        assert case == pcase
        seen.append(case)
        for group, jvals, pvals in (("inputs", jin, pin), ("outputs", jout, pout)):
            assert jvals.keys() == pvals.keys(), f"{case}: {group}"
            for name in jvals:
                _assert_same(case, name, jvals[name], pvals[name])
            bad = _differing(records.get(case, {}).get(group, {}), jvals)
            assert not bad, f"{case}: the JAX package's {group} differ from the record: {bad}"
    assert sorted(seen) == sorted(records), "the recorded cases are not the ones the file yields"
