"""The port's distributed four-step NTT against the JAX package's.

(a) ``dist_ntt_forward`` / ``dist_ntt_inverse`` at n=2048 (n1=32, n2=64)
    with two 40-bit primes over an 8-rank flat limb mesh, whole and on
    shards: the port's on ``["cpu"] * 8`` (its exchange is the corner
    turn's plain version here) equals ``jax.jit`` of the JAX package's over
    its 8 virtual CPU devices with ``exchange="all_to_all"`` (its
    ``"remote"`` exchange cannot run on the CPU), and the single-device
    transforms; the round trip gives the input back.
(b) the port's factorization rule equals ``build_mxu_tables``'.
(c) the corner turn's layout (``remote_corner_turn``, and
    ``corner_turn_plain`` on the inverse's transposed views) against the
    ``all_to_all`` collective, and what the distributed NTT refuses.

Every comparison is exact equality.
"""

import jax
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from seal_tpu import numth as jax_numth
from seal_tpu.modulus import Modulus as JaxModulus
from seal_tpu.ntt_tables import build_mxu_tables
from seal_tpu.ops import u64 as JU
from seal_tpu.parallel.dist_ntt import dist_ntt_forward as jax_dist_forward, dist_ntt_inverse as jax_dist_inverse

from seal_tpu_torch import numth
from seal_tpu_torch.convert import u64_from_numpy, u64_to_numpy
from seal_tpu_torch.modulus import Modulus
from seal_tpu_torch.ntt_tables import build_four_step_tables, build_limb_tables, default_split
from seal_tpu_torch.ops.four_step import four_step_forward, four_step_inverse
from seal_tpu_torch.ops.ntt import ntt_forward, ntt_inverse
from seal_tpu_torch.parallel.collectives import all_to_all
from seal_tpu_torch.parallel.dist_ntt import DistNTT, dist_ntt_forward, dist_ntt_inverse
from seal_tpu_torch.parallel.mesh import DeviceMesh
from seal_tpu_torch.parallel.remote_ntt import corner_turn_plain, remote_corner_turn

N = 2048
ROUTES = ("function", "shards")


@pytest.fixture(scope="module")
def setup():
    """Tables of both packages, the seeded input, and the JAX package's
    distributed transforms of it."""
    log_n = N.bit_length() - 1
    primes = numth.get_primes(2 * N, 40, 2)
    assert primes == jax_numth.get_primes(2 * N, 40, 2)
    mt = build_mxu_tables(log_n, [JaxModulus(p) for p in primes])
    ft = build_four_step_tables(log_n, [Modulus(p) for p in primes], device="cpu")
    lt = build_limb_tables(log_n, [Modulus(p) for p in primes], device="cpu")
    assert (ft.n1, ft.n2) == (mt.n1, mt.n2) == (32, 64)
    rng = np.random.default_rng(N)
    q = np.array(primes, dtype=np.uint64)[:, None]
    x = rng.integers(0, q, (2, N), dtype=np.uint64)
    y = rng.integers(0, 2 * q, (2, N), dtype=np.uint64)                  # an inverse input below 2q
    jmesh = Mesh(np.array(jax.devices()[:8]), ("limb",))
    fwd = jax.jit(lambda a: jax_dist_forward(a, mt, jmesh, exchange="all_to_all"))
    inv = jax.jit(lambda a: jax_dist_inverse(a, mt, jmesh, exchange="all_to_all"))
    jax_fwd = JU.to_np_u64(fwd(JU.from_np_u64(x)))
    jax_inv = JU.to_np_u64(inv(JU.from_np_u64(y)))
    mesh = DeviceMesh(["cpu"] * 8, ("limb",))
    return {"ft": ft, "lt": lt, "x": x, "y": y, "jax_fwd": jax_fwd, "jax_inv": jax_inv, "mesh": mesh}


@pytest.mark.parametrize("route", ROUTES)
def test_forward_matches_jax_and_single_device(setup, route):
    x = u64_from_numpy(setup["x"], "cpu")
    if route == "function":
        got = dist_ntt_forward(x, setup["ft"], setup["mesh"])
    else:
        dist = DistNTT(setup["ft"], setup["mesh"])
        got = dist.join_rows(dist.forward_shards(dist.split_columns(x)), "cpu")
    np.testing.assert_array_equal(u64_to_numpy(got), setup["jax_fwd"])
    assert torch.equal(got, four_step_forward(x, setup["ft"]))
    assert torch.equal(got, ntt_forward(x, setup["lt"]))


@pytest.mark.parametrize("route", ROUTES)
def test_inverse_matches_jax_and_round_trips(setup, route):
    y = u64_from_numpy(setup["y"], "cpu")
    dist = DistNTT(setup["ft"], setup["mesh"])
    if route == "function":
        got = dist_ntt_inverse(y, setup["ft"], setup["mesh"])
    else:
        got = dist.join_columns(dist.inverse_shards(dist.split_rows(y)), "cpu")
    np.testing.assert_array_equal(u64_to_numpy(got), setup["jax_inv"])
    assert torch.equal(got, four_step_inverse(y, setup["ft"]))
    assert torch.equal(got, ntt_inverse(y, setup["lt"]))
    x = u64_from_numpy(setup["x"], "cpu")
    assert torch.equal(dist.inverse(dist.forward(x)), x)


def test_shards_are_the_single_device_transform_split(setup):
    dist = DistNTT(setup["ft"], setup["mesh"])
    x = u64_from_numpy(setup["x"], "cpu")
    cols = dist.split_columns(x)
    rows = dist.forward_shards(cols)
    assert rows[0].shape == (2, N // 8)
    assert all(torch.equal(a, b) for a, b in zip(rows, dist.split_rows(four_step_forward(x, setup["ft"]))))
    assert all(torch.equal(a, b) for a, b in zip(dist.inverse_shards(rows), cols))


@pytest.mark.parametrize("log_n", [4, 11, 13, 15, 16, 17])
def test_factorization_matches_build_mxu_tables(log_n):
    n = 1 << log_n
    mt = build_mxu_tables(log_n, [JaxModulus(numth.get_primes(2 * n, 30, 1)[0])])
    assert default_split(log_n) == mt.n2


@pytest.mark.parametrize("P, k, r, c", [(8, 2, 4, 8), (2, 3, 1, 5), (4, 1, 2, 16)])
def test_corner_turn_layout(P, k, r, c):
    rng = np.random.default_rng(P * 100 + c)
    shards = [torch.from_numpy(rng.integers(0, 1 << 60, (k, P, r, c))) for _ in range(P)]
    out = remote_corner_turn(shards)
    for j, block in enumerate(all_to_all(shards, 1, 2)):
        assert out[j].shape == (k, r, P, c) and torch.equal(out[j], block)
        for m in range(P):
            assert torch.equal(out[j][:, :, m], shards[m][:, j])
    # transposed views in and out, as the inverse transform passes them
    srcs = [s.permute(0, 2, 1, 3).contiguous().transpose(1, 2) for s in shards]
    dsts = [torch.empty((k, P, r, c), dtype=torch.int64).transpose(1, 2) for _ in range(P)]
    corner_turn_plain(srcs, dsts)
    assert all(torch.equal(a, b) for a, b in zip(dsts, out))


def test_distributed_ntt_refuses_what_it_does_not_take(setup):
    with pytest.raises(ValueError, match="divide"):
        DistNTT(setup["ft"], DeviceMesh(["cpu"] * 3, ("limb",)))
    with pytest.raises(ValueError, match="size 1"):
        DistNTT(setup["ft"], DeviceMesh(np.array(["cpu"] * 8).reshape(2, 4), ("data", "limb")))
    dist = DistNTT(setup["ft"], setup["mesh"])
    x = u64_from_numpy(setup["x"], "cpu")
    with pytest.raises(ValueError):
        dist.forward(x[:, : N // 2])
