"""The port's tooling on the CPU: debug mode, profiling and the example twins.

(a) ``SEAL_TPU_DEBUG=1`` (``seal_tpu_torch/debug.py``): the JAX package's
    two cases of ``tests/test_debug_mode.py`` on the port (a BFV round trip
    at N=128 passes every range check; an NTT operand at 8q raises
    ``RangeError``), a clean round trip of each scheme whose outputs equal
    the run without the switch, and the other seams: the inverse NTT's
    input bound, the key-switch contraction's target bound, and a switch
    set to 0 or left empty, under which nothing is checked;
(b) ``profiling.py``: ``op_timer``, ``compile_stats`` and ``trace`` on the
    CPU; the device timers refuse work that is not on a card;
(c) the seven twins of ``examples/`` run to their asserts on the CPU.
"""

import importlib
import json
import os

import numpy as np
import pytest
import torch

import seal_tpu_torch as P
from seal_tpu_torch import debug, profiling
from seal_tpu_torch.ckks_bodies import key_switch_contract
from seal_tpu_torch.convert import u64_from_numpy
from seal_tpu_torch.examples import NAMES
from seal_tpu_torch.ntt_tables import build_limb_tables
from seal_tpu_torch.ops import ntt as NTT


def _context(scheme, n, bits, plain_bits=20):
    parms = P.EncryptionParameters(scheme)
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(P.CoeffModulus.create(n, bits))
    if scheme != P.SchemeType.CKKS:
        parms.set_plain_modulus(P.PlainModulus.batching(n, plain_bits))
    parms.set_random_generator(P.UniformRandomGeneratorFactory(P.PRNGType.BLAKE2XB, (5,) * 8))
    return P.SealContext(parms, True, P.SecurityLevel.NONE, device="cpu")


# -- (a) debug mode ---------------------------------------------------------------

def test_debug_mode_clean_roundtrip_passes(monkeypatch):
    """The JAX package's clean case: BFV N=128, square and relinearize."""
    monkeypatch.setenv("SEAL_TPU_DEBUG", "1")
    ctx = _context(P.SchemeType.BFV, 128, [40, 40, 40], plain_bits=14)
    kg = P.KeyGenerator(ctx)
    rk = kg.create_relin_keys()
    enc, dec = P.Encryptor(ctx, secret_key=kg.secret_key), P.Decryptor(ctx, kg.secret_key)
    ev, encoder = P.Evaluator(ctx), P.BatchEncoder(ctx)
    t = ctx.first_context_data().parms.plain_modulus.value
    vals = list(range(128))
    prod = ev.relinearize(ev.multiply(enc.encrypt_symmetric(encoder.encode(vals)), enc.encrypt_symmetric(
        encoder.encode(vals))), rk)
    np.testing.assert_array_equal(encoder.decode(dec.decrypt(prod)), [v * v % t for v in vals])


def test_debug_mode_catches_out_of_range_ntt_input(monkeypatch):
    """The JAX package's violation case: a coefficient at 8q >= 4q."""
    monkeypatch.setenv("SEAL_TPU_DEBUG", "1")
    mods = P.CoeffModulus.create(256, [30])
    tables = build_limb_tables(8, mods, device="cpu")
    bad = u64_from_numpy(np.full((1, 256), 8 * mods[0].value, dtype=np.uint64), "cpu")
    with pytest.raises(debug.RangeError, match="range violation: ntt_forward input < 4q"):
        NTT.forward(bad, tables)


def _chain(scheme):
    """A client and server round trip of the scheme at N=1024 (keygen,
    encryption, multiply, relinearize, a rotation, a modulus switch or a
    rescale, decryption); returns the last ciphertext and the decoded
    values with what they should be."""
    bits = [60, 40, 40, 60] if scheme == P.SchemeType.CKKS else [40, 40, 40, 40]
    ctx = _context(scheme, 1024, bits)
    kg = P.KeyGenerator(ctx)
    rk, gk = kg.create_relin_keys(), kg.create_galois_keys_from_steps([1, 0])
    enc, dec, ev = P.Encryptor(ctx, public_key=kg.create_public_key()), P.Decryptor(ctx, kg.secret_key), P.Evaluator(ctx)
    rng = np.random.default_rng(7)
    if scheme == P.SchemeType.CKKS:
        encoder = P.CKKSEncoder(ctx)
        v = rng.uniform(-1, 1, 512)
        ct = enc.encrypt(encoder.encode(v, 2.0 ** 40))
        out = ev.rotate_vector(ev.rescale_to_next(ev.relinearize(ev.square(ct), rk)), 1, gk)
        return out, encoder.decode(dec.decrypt(out)).real, np.roll(v * v, -1)
    encoder = P.BatchEncoder(ctx)
    t = ctx.first_context_data().parms.plain_modulus.value
    v = rng.integers(0, t, 1024, dtype=np.uint64)
    ct = enc.encrypt(encoder.encode(v))
    out = ev.mod_switch_to_next(ev.rotate_columns(ev.relinearize(ev.square(ct), rk), gk))
    sq = (v.astype(object) ** 2 % t).astype(np.uint64)
    return out, encoder.decode(dec.decrypt(out)), np.concatenate([sq[512:], sq[:512]])


@pytest.mark.parametrize("scheme", [P.SchemeType.BFV, P.SchemeType.BGV, P.SchemeType.CKKS], ids=lambda s: s.name)
def test_debug_mode_round_trip_of_each_scheme_equals_the_run_without(monkeypatch, scheme):
    monkeypatch.delenv("SEAL_TPU_DEBUG", raising=False)
    plain_out, _, _ = _chain(scheme)
    monkeypatch.setenv("SEAL_TPU_DEBUG", "1")
    out, got, want = _chain(scheme)
    assert torch.equal(out.data, plain_out.data)
    if scheme == P.SchemeType.CKKS:
        np.testing.assert_allclose(got, want, atol=1e-3)
    else:
        np.testing.assert_array_equal(got, want)


def test_debug_mode_checks_the_inverse_ntt_and_the_key_switch_target(monkeypatch):
    monkeypatch.setenv("SEAL_TPU_DEBUG", "1")
    ctx = _context(P.SchemeType.CKKS, 64, [40, 40, 40])
    cd = ctx.first_context_data()
    t = cd.limb_tables()
    with pytest.raises(debug.RangeError, match="ntt_inverse input < 2q"):
        NTT.inverse(t.two_q.expand(2, 64).clone(), t)
    bfv = _context(P.SchemeType.BFV, 64, [40, 40, 40])     # a coefficient-form target goes in as it is
    plan = P.Evaluator(bfv)._plan(bfv.first_context_data())
    key = torch.zeros((2, 3, 64), dtype=torch.int64)
    target = torch.zeros((2, 64), dtype=torch.int64)
    target[1, 5] = -1                                    # a u64 at 2^64 - 1
    with pytest.raises(debug.RangeError, match="switch_key target < 4q"):
        key_switch_contract(plan, target, key, key, 0, 2)


@pytest.mark.parametrize("value", ["0", ""])
def test_debug_mode_off_checks_nothing(monkeypatch, value):
    monkeypatch.setenv("SEAL_TPU_DEBUG", value)
    assert not debug.enabled()
    mods = P.CoeffModulus.create(256, [30])
    tables = build_limb_tables(8, mods, device="cpu")
    bad = u64_from_numpy(np.full((1, 256), 8 * mods[0].value, dtype=np.uint64), "cpu")
    NTT.forward(bad, tables)                                 # garbage in, no check
    assert debug.check_below_scalar(bad, 1, "unchecked") is bad


# -- (b) profiling ------------------------------------------------------------------

def test_op_timer_and_compile_stats_on_the_cpu():
    ctx = _context(P.SchemeType.BFV, 64, [40, 30, 30, 30, 40])
    kg = P.KeyGenerator(ctx)
    rk = kg.create_relin_keys()
    ct = P.Encryptor(ctx, secret_key=kg.secret_key).encrypt_symmetric(P.Plaintext.from_coeffs([1, 2, 3]))
    ev = P.Evaluator(ctx)
    seconds = profiling.op_timer(lambda c: ev.relinearize(ev.square(c), rk), ct, iters=3)
    assert seconds > 0
    stats = profiling.compile_stats(ctx, ev)
    assert stats["tables q"] >= 2 and stats["tables behz"] == 1 and stats["key_switch_plan"] == 1
    assert stats["behz"] == 1 and stats["convert"] >= 3
    ev.mod_switch_to_next(ct)
    assert profiling.compile_stats(ctx, ev)["rescale"] == stats.get("rescale", 0) + 1


def test_trace_writes_a_chrome_trace(tmp_path):
    x = torch.arange(1 << 12, dtype=torch.int64)
    with profiling.trace(str(tmp_path)) as prof:
        (x * 3 + 1).sum()
    with open(os.path.join(tmp_path, "trace.json")) as f:
        events = json.load(f)["traceEvents"]
    assert any("mul" in e.get("name", "") for e in events)
    assert prof.key_averages()


def test_device_timers_refuse_the_cpu():
    x = torch.ones(8)
    with pytest.raises(ValueError, match="times work on the card"):
        profiling.device_time_us(lambda: x + 1)
    with pytest.raises(ValueError, match="times work on the card"):
        profiling.chained_device_time_us(lambda c: c + 1, x)
    assert profiling.serialize_dependency(None, x, x + 1) is x


# -- (c) the example twins --------------------------------------------------------------

@pytest.mark.parametrize("name", NAMES)
def test_example_twin_runs_on_the_cpu(name, capsys):
    importlib.import_module(f"seal_tpu_torch.examples.{name}").main("cpu")
    assert capsys.readouterr().out.rstrip().endswith("OK")
