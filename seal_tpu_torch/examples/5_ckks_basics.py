"""CKKS basics: evaluate PI*x^3 + 0.4x + 1 on encrypted real vectors.

Twin of ``examples/5_ckks_basics.py`` (the reference's ``5_ckks_basics.cpp``:
rescaling chain, scale alignment, level switching) on the port.
"""

import numpy as np

from seal_tpu_torch import (CKKSEncoder, CoeffModulus, Decryptor, EncryptionParameters, Encryptor, Evaluator,
                            KeyGenerator, SchemeType, SealContext, print_parameters)


def main(device=None):
    parms = EncryptionParameters(SchemeType.CKKS)
    n = 8192
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [60, 40, 40, 60]))
    context = SealContext(parms, device=device)
    print_parameters(context)

    keygen = KeyGenerator(context)
    pk = keygen.create_public_key()
    rk = keygen.create_relin_keys()
    encryptor = Encryptor(context, public_key=pk)
    evaluator = Evaluator(context)
    decryptor = Decryptor(context, keygen.secret_key)
    encoder = CKKSEncoder(context)

    scale = 2.0**40
    inputs = np.linspace(0.0, 1.0, encoder.slots)
    x1 = encryptor.encrypt(encoder.encode(inputs, scale))

    # x^2 -> rescale
    x2 = evaluator.rescale_to_next(evaluator.relinearize(evaluator.square(x1), rk))
    # PI * x -> rescale
    pi_x = evaluator.rescale_to_next(
        evaluator.multiply_plain(x1, encoder.encode(3.14159265, scale))
    )
    # (PI*x) * x^2 -> rescale  (scales/levels aligned first)
    x3 = evaluator.rescale_to_next(evaluator.relinearize(evaluator.multiply(x2, pi_x), rk))

    # 0.4 * x at matching level
    x1_04 = evaluator.rescale_to_next(
        evaluator.multiply_plain(x1, encoder.encode(0.4, scale))
    )
    x1_04 = evaluator.mod_switch_to(x1_04, x3.parms_id)

    # normalize scales (they differ slightly from 2^40 after rescale)
    x3.scale = 2.0**40
    x1_04.scale = 2.0**40
    plain1 = encoder.encode(1.0, x3.parms_id, scale=2.0**40)
    result = evaluator.add_plain(evaluator.add(x3, x1_04), plain1)

    got = encoder.decode(decryptor.decrypt(result)).real
    want = 3.14159265 * inputs**3 + 0.4 * inputs + 1
    err = np.max(np.abs(got - want))
    print(f"max error: {err:.2e}")
    assert err < 1e-4
    print("OK")


if __name__ == "__main__":
    main()
