"""BGV basics: x^4 via two multiplications with modulus switching.

Twin of ``examples/4_bgv_basics.py`` (the reference's ``4_bgv_basics.cpp``)
on the port.
"""

from seal_tpu_torch import (BatchEncoder, CoeffModulus, Decryptor, EncryptionParameters, Encryptor, Evaluator,
                            KeyGenerator, PlainModulus, SchemeType, SealContext, print_parameters)


def main(device=None):
    parms = EncryptionParameters(SchemeType.BGV)
    n = 8192
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.bfv_default(n))
    parms.set_plain_modulus(PlainModulus.batching(n, 20).value)
    context = SealContext(parms, device=device)
    print_parameters(context)

    keygen = KeyGenerator(context)
    pk = keygen.create_public_key()
    rk = keygen.create_relin_keys()
    encryptor = Encryptor(context, public_key=pk)
    evaluator = Evaluator(context)
    decryptor = Decryptor(context, keygen.secret_key)
    encoder = BatchEncoder(context)

    vals = list(range(encoder.slots))
    x = encryptor.encrypt(encoder.encode(vals))
    print(f"fresh noise budget: {decryptor.invariant_noise_budget(x)} bits")

    x2 = evaluator.relinearize(evaluator.square(x), rk)
    print(f"x^2 noise budget: {decryptor.invariant_noise_budget(x2)} bits")
    x2 = evaluator.mod_switch_to_next(x2)
    print(f"x^2 after mod switch: {decryptor.invariant_noise_budget(x2)} bits")
    x4 = evaluator.relinearize(evaluator.square(x2), rk)
    print(f"x^4 noise budget: {decryptor.invariant_noise_budget(x4)} bits")

    t = context.first_context_data().parms.plain_modulus.value
    got = encoder.decode(decryptor.decrypt(x4))
    want = [pow(v, 4, t) for v in vals]
    assert list(got) == want
    print("OK")


if __name__ == "__main__":
    main()
