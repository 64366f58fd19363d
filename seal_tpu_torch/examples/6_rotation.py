"""Rotations: BFV row/column rotations and CKKS vector rotations.

Twin of ``examples/6_rotation.py`` (the reference's ``6_rotation.cpp``) on
the port.
"""

import numpy as np

from seal_tpu_torch import (BatchEncoder, CKKSEncoder, CoeffModulus, Decryptor, EncryptionParameters, Encryptor,
                            Evaluator, KeyGenerator, PlainModulus, SchemeType, SealContext)


def bfv_rotation(device=None):
    parms = EncryptionParameters(SchemeType.BFV)
    n = 8192
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.bfv_default(n))
    parms.set_plain_modulus(PlainModulus.batching(n, 20).value)
    ctx = SealContext(parms, device=device)
    keygen = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=keygen.create_public_key())
    dec = Decryptor(ctx, keygen.secret_key)
    ev = Evaluator(ctx)
    be = BatchEncoder(ctx)
    gk = keygen.create_galois_keys()

    row = n // 2
    vals = [0] * n
    vals[0], vals[1], vals[row], vals[row + 1] = 1, 2, 3, 4
    ct = enc.encrypt(be.encode(vals))

    r3 = ev.rotate_rows(ct, 3, gk)
    got = be.decode(dec.decrypt(r3))
    assert got[row - 3] == 1 and got[row - 2] == 2
    cols = ev.rotate_columns(ct, gk)
    got = be.decode(dec.decrypt(cols))
    assert got[0] == 3 and got[1] == 4
    print("BFV rotations OK")


def ckks_rotation(device=None):
    parms = EncryptionParameters(SchemeType.CKKS)
    n = 8192
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [40, 40, 40, 40, 40]))
    ctx = SealContext(parms, device=device)
    keygen = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=keygen.create_public_key())
    dec = Decryptor(ctx, keygen.secret_key)
    ev = Evaluator(ctx)
    encoder = CKKSEncoder(ctx)
    gk = keygen.create_galois_keys()

    vals = np.linspace(0, 1, encoder.slots)
    ct = enc.encrypt(encoder.encode(vals, 2.0**40))
    rot = ev.rotate_vector(ct, 2, gk)
    got = encoder.decode(dec.decrypt(rot)).real
    assert np.allclose(got, np.roll(vals, -2), atol=1e-5)
    print("CKKS rotations OK")


def main(device=None):
    bfv_rotation(device)
    ckks_rotation(device)


if __name__ == "__main__":
    main()
