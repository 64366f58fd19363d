"""Kernel E's dispatch and layout (``ops/u64.py``, ``ops/cuda_modarith.py``)
without a card.

The modular functions of ``ops/u64.py`` run their plain bodies on the CPU
and, inside ``plain_on_card()``, on the card; outside it a tensor on the
card goes to ``modarith_cuda``, once a call.  The wrapper's layout (each
operand's pointer and strides over the collapsed broadcast shape) is
checked by reading the operands' storage the way the kernel reads it
(``as_strided`` with those strides from each operand's own storage offset)
and comparing with the plain function on the operands as given.  The
kernel itself is compared with the plain bodies on the card
(``tests/test_torch_cuda.py``).
"""

import pytest
import torch

from seal_tpu_torch.ntt_tables import u64_tensor
from seal_tpu_torch.ops import cuda_modarith as CM
from seal_tpu_torch.ops import ntt as NTT
from seal_tpu_torch.ops import u64 as U

M64 = (1 << 64) - 1
Q = [(1 << 55) - 55, (1 << 59) - 55, (1 << 40) - 87, 1032193]
K = len(Q)


class _OnCard(torch.Tensor):
    """A CPU tensor that reports itself as a CUDA tensor, to test the
    dispatch without a card."""

    @property
    def is_cuda(self):
        return True


def _col(values):
    return u64_tensor([[v] for v in values])


def _constants():
    ratio = [(1 << 128) // q for q in Q]
    y = [(q * 5) // 7 for q in Q]
    return {"q": _col(Q), "ratio_lo": _col([r & M64 for r in ratio]), "ratio_hi": _col([r >> 64 for r in ratio]),
            "y": _col(y), "y_quot": _col([(v << 64) // q for v, q in zip(y, Q)])}


def _words(shape, seed):
    """Full-range 64-bit words."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(-(1 << 63), (1 << 63) - 1, shape, dtype=torch.int64, generator=g)


def _below(shape, bound, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 1 << 62, shape, dtype=torch.int64, generator=g) % bound


def _args(name, shape=(2, K, 16)):
    """Reduced operands of the function ``name``, in its argument order."""
    c = _constants()
    x, y = _below(shape, c["q"], 1), _below(shape, c["q"], 2)
    return {
        "add_mod": (x, y, c["q"]),
        "sub_mod": (x, y, c["q"]),
        "neg_mod": (x, c["q"]),
        "barrett_reduce_64": (_words(shape, 3), c["q"], c["ratio_hi"]),
        "barrett_reduce_128": ((_words(shape, 4), _below(shape, c["q"], 5)), c["q"], c["ratio_lo"], c["ratio_hi"]),
        "mul_mod": (x, y, c["q"], c["ratio_lo"], c["ratio_hi"]),
        "mul_mod_shoup": (_words(shape, 6), c["y"], c["y_quot"], c["q"]),
        "mul_mod_shoup_lazy": (_words(shape, 6), c["y"], c["y_quot"], c["q"]),
    }[name]


def _exact(name, args):
    """The function's value by Python integers, on reduced u64 inputs."""
    def u(t):
        return [[[v & M64 for v in row] for row in m] for m in t.broadcast_to(args_shape).tolist()]

    flat = [a for arg in args for a in (arg if isinstance(arg, tuple) else (arg,))]
    args_shape = torch.broadcast_shapes(*(a.shape for a in flat))
    vals = [u(a) for a in flat]
    f = {
        "add_mod": lambda x, y, q: (x + y) % q,
        "sub_mod": lambda x, y, q: (x - y) % q,
        "neg_mod": lambda x, q: (-x) % q,
        "barrett_reduce_64": lambda x, q, r: x % q,
        "barrett_reduce_128": lambda lo, hi, q, r0, r1: ((hi << 64) | lo) % q,
        "mul_mod": lambda x, y, q, r0, r1: (x * y) % q,
        "mul_mod_shoup": lambda x, y, yq, q: (x * y) % q,
    }[name]
    out = [[[f(*(v[b][i][j] for v in vals)) for j in range(args_shape[2])] for i in range(args_shape[1])]
           for b in range(args_shape[0])]
    return u64_tensor(out)


def _on_card(args):
    return tuple(_on_card(a) if isinstance(a, tuple) else a.as_subclass(_OnCard) for a in args)


def _plain(t):
    return t.as_subclass(torch.Tensor)


def _operands(name, args):
    return list(args[0]) + list(args[1:]) if name == "barrett_reduce_128" else list(args)


@pytest.mark.parametrize("name", sorted(CM.OPS))
def test_cpu_tensors_run_the_plain_bodies(monkeypatch, name):
    monkeypatch.setattr(U, "modarith_cuda", lambda *a: pytest.fail("launched kernel E for CPU tensors"))
    args = _args(name)
    got = getattr(U, name)(*args)
    if name == "mul_mod_shoup_lazy":
        q = _constants()["q"]
        assert bool(((got >= 0) & (got < 2 * q)).all())
        assert torch.equal(torch.where(got >= q, got - q, got), _exact("mul_mod_shoup", args))
    else:
        assert torch.equal(got, _exact(name, args))


@pytest.mark.parametrize("name", sorted(CM.OPS))
def test_card_tensors_go_to_kernel_e_once_and_plain_inside_the_switch(monkeypatch, name):
    """Outside ``plain_on_card()`` one call of ``modarith_cuda`` with the
    function's operands in order; inside it, and after an exception inside
    it, as the switch says."""
    calls = []

    def fake(op, *operands):
        calls.append((op, operands))
        return _emulate(op, [_plain(a) for a in operands])

    monkeypatch.setattr(U, "modarith_cuda", fake)
    args = _args(name)
    want = getattr(U, name)(*args)
    got = getattr(U, name)(*_on_card(args))
    assert len(calls) == 1 and calls[0][0] == name
    assert [a.data_ptr() for a in calls[0][1]] == [a.data_ptr() for a in _operands(name, args)]
    assert torch.equal(_plain(got), want)

    monkeypatch.setattr(U, "modarith_cuda", lambda *a: pytest.fail("launched kernel E inside plain_on_card"))
    with NTT.plain_on_card():
        assert torch.equal(_plain(getattr(U, name)(*_on_card(args))), want)
    with pytest.raises(RuntimeError), U.plain_on_card():
        raise RuntimeError
    assert U.use_kernels(_on_card(args)[-1]) and NTT.plain_on_card is U.plain_on_card


def test_the_wrapper_refuses_what_the_kernel_does_not_take():
    x = torch.zeros((2, 4), dtype=torch.int64)
    with pytest.raises(ValueError, match="CUDA"):
        CM.modarith_cuda("add_mod", x, x, x)
    with pytest.raises(ValueError, match="3 operands"):
        CM.modarith_cuda("add_mod", x, x)
    with pytest.raises(ValueError, match="int64"):
        CM.modarith_cuda("neg_mod", x.to(torch.int32), x)
    with pytest.raises(KeyError):
        CM.modarith_cuda("mul64_wide", x, x)
    with pytest.raises(ValueError, match="do not broadcast"):
        CM.layout([x, torch.zeros((3, 4), dtype=torch.int64)])


# ---- the layout ---------------------------------------------------------------

def _emulate(name, operands):
    """What the kernel computes from the wrapper's layout: each operand read
    from its storage at the layout's strides, the plain body applied
    elementwise over the collapsed axes."""
    shape, dims, read = CM.layout(operands)
    flat = [t.as_strided(dims, strides, t.storage_offset()) for t, strides in read]
    args = ((flat[0], flat[1]), *flat[2:]) if name == "barrett_reduce_128" else flat
    with NTT.plain_on_card():
        return getattr(U, name)(*args).reshape(shape)


def _big(lead, n, seed):
    return _words((*lead, K, n), seed)


# (name, operands) of every layout the port passes: full tensors, slices
# along leading axes, per-limb (k, 1) and (1, 1) constants, 0-dim
# constants, and last-limb tensors (..., 1, n) broadcast over the limbs
def _layouts():
    c = _constants()
    q, rlo, rhi, y, yq = c["q"], c["ratio_lo"], c["ratio_hi"], c["y"], c["y_quot"]
    full = _big((4, 2), 32, 10)
    three = _big((4, 3), 32, 11)
    last = _words((4, 2, 1, 32), 12)
    k1 = K - 1
    return {
        "full": ("mul_mod", (full, _big((4, 2), 32, 13), q, rlo, rhi)),
        "ct_data[..., :2, :, :]": ("add_mod", (three[..., :2, :, :], full, q)),
        "new[..., :1, :, :] over the ciphertext axis": ("add_mod", (full[..., :1, :, :], three[..., :2, :, :], q)),
        "x[..., :k-1, :] with sliced constants": ("mul_mod_shoup", (full[..., :k1, :], y[:k1], yq[:k1], q[:k1])),
        "prod[..., lo:hi, :]": ("barrett_reduce_128", (three[:, 1:, 1:3, :], full[..., 1:3, :], q[1:3], rlo[1:3],
                                                        rhi[1:3])),
        "(..., 1, n) over the limbs": ("barrett_reduce_64", (last, q[:k1], rhi[:k1])),
        "(1, 1) constants": ("mul_mod_shoup_lazy", (full, y[:1], yq[:1], q[:1])),
        "0-dim constants": ("barrett_reduce_64", (full[:, 0, 2], q[2, 0], rhi[2, 0])),
        "full-size constants": ("sub_mod", (full, three[..., 1:, :, :], q.expand(K, 32).contiguous())),
        "one row": ("neg_mod", (full[1, 1, 2], q[2])),
    }


LAYOUTS = _layouts()


@pytest.mark.parametrize("case", sorted(LAYOUTS))
def test_layout_reads_each_port_layout_in_place(case):
    name, operands = LAYOUTS[case]
    operands = list(operands)
    shape, dims, read = CM.layout(operands)
    assert shape == tuple(torch.broadcast_shapes(*(a.shape for a in operands)))
    assert 1 <= len(dims) <= CM.MAX_DIMS and all(d > 1 for d in dims[:-1])
    for (t, strides), a in zip(read, operands):
        assert t is a, "copied an operand the kernel can read where it lies"
        assert len(strides) == len(dims) and strides[-1] in (0, 1)
    args = ((operands[0], operands[1]), *operands[2:]) if name == "barrett_reduce_128" else operands
    assert torch.equal(_emulate(name, operands), getattr(U, name)(*args))


def test_layout_of_per_limb_constants_over_a_batch():
    """(8, 2, 15, n) data with (15, 1) constants: three axes, the batch axes
    merged, the constants' stride 1 on the limb axis and 0 elsewhere."""
    x = torch.zeros((8, 2, 15, 64), dtype=torch.int64)
    q = torch.zeros((15, 1), dtype=torch.int64)
    shape, dims, read = CM.layout([x, x, q])
    assert shape == (8, 2, 15, 64) and dims == (16, 15, 64)
    assert [s for _, s in read] == [(960, 64, 1), (960, 64, 1), (0, 1, 0)]


@pytest.mark.parametrize("view", ["every other word", "transposed", "rows of a wider tensor"])
def test_layout_copies_only_an_operand_strided_on_its_last_axis(view):
    c = _constants()
    full = _big((2,), 32, 20)
    strided = {"every other word": _big((2,), 64, 21)[..., ::2],
               "transposed": _words((2, 32, K), 22).transpose(-1, -2),
               "rows of a wider tensor": _big((2,), 48, 23)[..., 8:40]}[view]
    operands = [strided, full, c["q"]]
    _, dims, read = CM.layout(operands)
    copied = [t is not a for (t, _), a in zip(read, operands)]
    assert copied == [view != "rows of a wider tensor", False, False]
    assert all(s[-1] in (0, 1) for _, s in read) and len(dims) <= CM.MAX_DIMS
    assert torch.equal(_emulate("add_mod", operands), U.add_mod(*operands))
