"""``roofline.py`` reproduces the bounds that ``chip_smoke.py`` printed and
PERF.md keeps in its kernel table."""

import pytest

from portbench.roofline import bound_ms, ntt_work, switch_key_work


def test_kernel_a_ckks_n8192_request():
    # the five transforms of a CKKS N=8192 request on [60, 40, 40, 40, 60]:
    # the key switch's iNTT of the target, iNTT mod the special prime and
    # tail NTT; the rescale's iNTT mod q_last and NTT
    calls = [(4, 4), (2, 1), (8, 4), (2, 1), (6, 3)]
    nbytes = sum(ntt_work(rows, k, 13)[0] for rows, k in calls)
    ops = sum(ntt_work(rows, k, 13)[1] for rows, k in calls)
    ms, by = bound_ms(nbytes, ops)
    assert by == "bytes"
    assert round(ms, 5) == 0.00137


@pytest.mark.parametrize("D, Rn, log_n, want", [(15, 16, 15, 0.0449), (4, 5, 13, 0.00133)])
def test_kernel_b_request(D, Rn, log_n, want):
    ms, by = bound_ms(*switch_key_work(D, D, Rn, log_n, True))
    assert by == "bytes"
    assert round(ms, len(str(want).split(".")[1])) == want


def test_batch_scales_the_ciphertexts_not_the_key():
    one = switch_key_work(15, 15, 16, 15, True, B=1)
    eight = switch_key_work(15, 15, 16, 15, True, B=8)
    n = 1 << 15
    key_and_tables = 8 * n * (2 * 15 * 16 + 2 * 16)
    assert eight[0] - key_and_tables == 8 * (one[0] - key_and_tables)
    assert eight[1] == 8 * one[1]
