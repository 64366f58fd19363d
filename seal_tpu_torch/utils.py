"""Introspection helpers (counterpart of ``examples/examples.h``'s utilities).

Port of ``seal_tpu/utils.py``: the same string for the same parameters.
"""

from __future__ import annotations

from .context import SealContext
from .params import SchemeType


def print_parameters(context: SealContext) -> str:
    """Print the encryption parameters of the key level, as the reference's
    examples do, and return the string."""
    parms = context.key_context_data().parms
    bits = [m.bit_count for m in parms.coeff_modulus]
    lines = ["/", "| Encryption parameters :", f"|   scheme: {parms.scheme.name}",
             f"|   poly_modulus_degree: {parms.poly_modulus_degree}",
             f"|   coeff_modulus size: {sum(bits)} ({' + '.join(map(str, bits))}) bits"]
    if parms.scheme in (SchemeType.BFV, SchemeType.BGV):
        lines.append(f"|   plain_modulus: {parms.plain_modulus.value}")
    lines.append("\\")
    s = "\n".join(lines)
    print(s)
    return s
