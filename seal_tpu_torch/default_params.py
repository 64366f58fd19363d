"""Default coefficient modulus tables: a copy of ``seal_tpu/default_params.py``
(data parity with the reference's ``util/globals.cpp:21+`` prime lists,
128/192/256-bit security)."""

DEFAULT_COEFF_MODULUS_128 = {
    1024: [0x7e00001],
    2048: [0x3fffffff000001],
    4096: [0xffffee001, 0xffffc4001, 0x1ffffe0001],
    8192: [0x7fffffd8001, 0x7fffffc8001, 0xfffffffc001, 0xffffff6c001, 0xfffffebc001],
    16384: [0xfffffffd8001, 0xfffffffa0001, 0xfffffff00001, 0x1fffffff68001, 0x1fffffff50001, 0x1ffffffee8001, 0x1ffffffea0001, 0x1ffffffe88001, 0x1ffffffe48001],
    32768: [0x7fffffffe90001, 0x7fffffffbf0001, 0x7fffffffbd0001, 0x7fffffffba0001, 0x7fffffffaa0001, 0x7fffffffa50001, 0x7fffffff9f0001, 0x7fffffff7e0001, 0x7fffffff770001, 0x7fffffff380001, 0x7fffffff330001, 0x7fffffff2d0001, 0x7fffffff170001, 0x7fffffff150001, 0x7ffffffef00001, 0xfffffffff70001],
}

DEFAULT_COEFF_MODULUS_192 = {
    1024: [0x7f001],
    2048: [0x1ffffc0001],
    4096: [0x1ffc001, 0x1fce001, 0x1fc0001],
    8192: [0x3ffffac001, 0x3ffff54001, 0x3ffff48001, 0x3ffff28001],
    16384: [0x3ffffffdf0001, 0x3ffffffd48001, 0x3ffffffd20001, 0x3ffffffd18001, 0x3ffffffcd0001, 0x3ffffffc70001],
    32768: [0x3fffffffd60001, 0x3fffffffca0001, 0x3fffffff6d0001, 0x3fffffff5d0001, 0x3fffffff550001, 0x7fffffffe90001, 0x7fffffffbf0001, 0x7fffffffbd0001, 0x7fffffffba0001, 0x7fffffffaa0001, 0x7fffffffa50001],
}

DEFAULT_COEFF_MODULUS_256 = {
    1024: [0x3001],
    2048: [0x1ffc0001],
    4096: [0x3ffffffff040001],
    8192: [0x7ffffec001, 0x7ffffb0001, 0xfffffdc001],
    16384: [0x7ffffffc8001, 0x7ffffff00001, 0x7fffffe70001, 0xfffffffd8001, 0xfffffffa0001],
    32768: [0xffffffff00001, 0x1fffffffe30001, 0x1fffffffd80001, 0x1fffffffd10001, 0x1fffffffc50001, 0x1fffffffbf0001, 0x1fffffffb90001, 0x1fffffffb60001, 0x1fffffffa50001],
}
