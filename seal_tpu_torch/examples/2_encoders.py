"""Encoders: BatchEncoder slot matrices and CKKSEncoder real vectors.

Twin of ``examples/2_encoders.py`` (the reference's ``2_encoders.cpp``) on
the port.
"""

import numpy as np

from seal_tpu_torch import (BatchEncoder, CKKSEncoder, CoeffModulus, Decryptor, EncryptionParameters, Encryptor,
                            Evaluator, KeyGenerator, PlainModulus, SchemeType, SealContext)


def batch_encoder_demo(device=None):
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

    mat = [0] * n
    mat[0], mat[1], mat[2], mat[3] = 0, 1, 2, 3
    ct = enc.encrypt(be.encode(mat))
    # slot-wise (x + 7)^2
    p7 = be.encode([7] * n)
    sq = ev.square(ev.add_plain(ct, p7))
    got = be.decode(dec.decrypt(sq))
    assert list(got[:4]) == [(v + 7) ** 2 for v in mat[:4]]
    # signed variant
    signed = be.encode_int64([-3, -2, -1, 0, 1, 2, 3])
    assert list(be.decode_int64(signed)[:7]) == [-3, -2, -1, 0, 1, 2, 3]
    print("BatchEncoder OK")


def ckks_encoder_demo(device=None):
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

    vals = np.array([0.0, 1.1, 2.2, 3.3])
    # match the scale to the 40-bit rescale primes (5_ckks_basics pattern):
    # after square (2^80) and rescale (/2^40) the scale returns to 2^40
    scale = 2.0**40
    ct = enc.encrypt(encoder.encode(vals, scale))
    sq = ev.rescale_to_next(ev.relinearize(ev.square(ct), keygen.create_relin_keys()))
    got = encoder.decode(dec.decrypt(sq)).real[:4]
    assert np.allclose(got, vals**2, atol=1e-3)
    print("CKKSEncoder OK")


def main(device=None):
    batch_encoder_demo(device)
    ckks_encoder_demo(device)


if __name__ == "__main__":
    main()
