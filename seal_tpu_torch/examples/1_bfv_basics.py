"""BFV basics: encrypted integer arithmetic 4(x^2+1)(x+1)^2 for x=6.

Twin of ``examples/1_bfv_basics.py`` (the reference's ``1_bfv_basics.cpp``)
on the port.
"""

from seal_tpu_torch import (CoeffModulus, Decryptor, EncryptionParameters, Encryptor, Evaluator, KeyGenerator,
                            Plaintext, SchemeType, SealContext, print_parameters)


def main(device=None):
    parms = EncryptionParameters(SchemeType.BFV)
    n = 4096
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.bfv_default(n))
    parms.set_plain_modulus(1024)
    context = SealContext(parms, device=device)
    print_parameters(context)

    keygen = KeyGenerator(context)
    public_key = keygen.create_public_key()
    relin_keys = keygen.create_relin_keys()
    encryptor = Encryptor(context, public_key=public_key)
    evaluator = Evaluator(context)
    decryptor = Decryptor(context, keygen.secret_key)

    x = 6
    x_plain = Plaintext.from_hex(format(x, "x"))
    x_encrypted = encryptor.encrypt(x_plain)
    print(f"fresh noise budget: {decryptor.invariant_noise_budget(x_encrypted)} bits")

    # (x^2 + 1)
    x_sq_plus_one = evaluator.add_plain(
        evaluator.relinearize(evaluator.square(x_encrypted), relin_keys), Plaintext.from_hex("1")
    )
    # (x + 1)^2
    x_plus_one_sq = evaluator.relinearize(
        evaluator.square(evaluator.add_plain(x_encrypted, Plaintext.from_hex("1"))), relin_keys
    )
    # 4(x^2+1)(x+1)^2
    result = evaluator.relinearize(
        evaluator.multiply(
            evaluator.multiply_plain(x_sq_plus_one, Plaintext.from_hex("4")), x_plus_one_sq
        ),
        relin_keys,
    )
    print(f"result noise budget: {decryptor.invariant_noise_budget(result)} bits")
    decrypted = decryptor.decrypt(result)
    value = int(decrypted.coeff_data[0])
    expected = 4 * (x * x + 1) * (x + 1) ** 2 % 1024
    print(f"4(x^2+1)(x+1)^2 mod 1024 = {value} (expected {expected})")
    assert value == expected
    print("OK")


if __name__ == "__main__":
    main()
