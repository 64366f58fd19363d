"""Levels: the modulus switching chain, parms_ids, and key/data levels.

Twin of ``examples/3_levels.py`` (the reference's ``3_levels.cpp``) on the
port.
"""

from seal_tpu_torch import (CoeffModulus, Decryptor, EncryptionParameters, Encryptor, Evaluator, KeyGenerator,
                            Plaintext, SchemeType, SealContext)


def main(device=None):
    parms = EncryptionParameters(SchemeType.BFV)
    n = 8192
    parms.set_poly_modulus_degree(n)
    parms.set_coeff_modulus(CoeffModulus.create(n, [50, 30, 30, 50, 50]))
    parms.set_plain_modulus(1 << 20)
    ctx = SealContext(parms, device=device)

    print("Modulus switching chain (key level first):")
    cd = ctx.key_context_data()
    while cd is not None:
        tag = ""
        if cd.parms_id == ctx.key_parms_id:
            tag = " (key level)"
        elif cd.parms_id == ctx.first_parms_id:
            tag = " (first/data level)"
        bits = [m.bit_count for m in cd.parms.coeff_modulus]
        print(f"  chain_index {cd.chain_index}: {len(bits)} primes {bits}{tag}")
        cd = cd.next_context_data

    keygen = KeyGenerator(ctx)
    enc = Encryptor(ctx, public_key=keygen.create_public_key())
    dec = Decryptor(ctx, keygen.secret_key)
    ev = Evaluator(ctx)

    p = Plaintext.from_hex("1x^3 + 2x^2 + 3x^1 + 4")
    ct = enc.encrypt(p)
    while True:
        print(f"  level {ctx.get_context_data(ct.parms_id).chain_index}: "
              f"noise budget {dec.invariant_noise_budget(ct)} bits")
        if ct.parms_id == ctx.last_parms_id:
            break
        ct = ev.mod_switch_to_next(ct)
    assert dec.decrypt(ct).to_string() == p.to_string()
    print("OK")


if __name__ == "__main__":
    main()
