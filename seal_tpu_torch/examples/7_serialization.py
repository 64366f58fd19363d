"""Serialization: client/server flow with seeded (compressed) ciphertexts.

Twin of ``examples/7_serialization.py`` (the reference's
``7_serialization.cpp``) on the port.
"""

import numpy as np

from seal_tpu_torch import (CKKSEncoder, CoeffModulus, Decryptor, EncryptionParameters, Encryptor, Evaluator,
                            KeyGenerator, SchemeType, SealContext)
from seal_tpu_torch import serialization as S


def main(device=None):
    # Server and client agree on parameters via serialization
    parms = EncryptionParameters(SchemeType.CKKS)
    n = 8192
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [50, 30, 50]))
    parms_bytes = S.params_save(parms)
    print(f"EncryptionParameters: {len(parms_bytes)} bytes")

    parms2, _ = S.params_load(parms_bytes)
    assert parms2.parms_id == parms.parms_id
    ctx = SealContext(parms2, device=device)

    # Client: keygen, encrypt with seeded compression
    keygen = KeyGenerator(ctx)
    sk = keygen.secret_key
    encoder = CKKSEncoder(ctx)
    enc = Encryptor(ctx, secret_key=sk)
    scale = 2.0**30

    ct1 = enc.encrypt_symmetric(encoder.encode(np.array([3.1]), scale), save_seed=True)
    ct2 = enc.encrypt_symmetric(encoder.encode(np.array([4.2]), scale), save_seed=True)
    b1, b2 = S.ciphertext_save(ct1), S.ciphertext_save(ct2)
    full = S.ciphertext_save(enc.encrypt_symmetric(encoder.encode(np.array([3.1]), scale)))
    print(f"seeded ciphertext: {len(b1)} bytes vs full {len(full)} bytes")

    # Server: load, compute ct1*ct2 + plain, send back
    ev = Evaluator(ctx)
    c1, _ = S.ciphertext_load(b1, ctx)
    c2, _ = S.ciphertext_load(b2, ctx)
    prod = ev.rescale_to_next(ev.multiply(c1, c2))
    result_bytes = S.ciphertext_save(prod)

    # Client: decrypt
    dec = Decryptor(ctx, sk)
    result, _ = S.ciphertext_load(result_bytes, ctx)
    got = encoder.decode(dec.decrypt(result)).real[0]
    print(f"3.1 * 4.2 = {got:.4f}")
    assert abs(got - 3.1 * 4.2) < 1e-2
    print("OK")


if __name__ == "__main__":
    main()
