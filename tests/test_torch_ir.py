"""The port's tensor-IR layer (``fiat_tpu_torch.ir``) against fiat_tpu's
(``fiat_tpu.ir``) on the CPU.

* ``contract`` against ``fiat_tpu.ir.contract`` at RTOL relative, its
  path numpy's ``einsum_path(..., optimize="optimal")``, applied as
  pairwise ``torch.einsum`` calls.
* ``unconcatenate`` equal to fiat_tpu's.
* ``evaluate`` and ``as_graph(...)(x)`` equal to the direct call, on
  plain torch functions and on the symbolic tensor path
  (``basis_evaluation`` on an ``UnknownPointSet``); ``pprint`` and
  ``lower_text`` name the traced operators.
* ``cost_analysis``'s flops equal to fiat_tpu's (XLA's cost model) on a
  product chain and on elementwise arithmetic and reductions, its
  transcendentals on ``sin`` / ``exp``.
* ``as_graph`` refuses by name (``NotTraceable``) a function that reads a
  tensor's ``data_ptr()`` (as every kernel wrapper does on the card) or
  a value on the host."""

import numpy as np
import pytest
import torch

import fiat_tpu.ir as jir
import fiat_tpu_torch as ft
import fiat_tpu_torch.ir as tir
from fiat_tpu_torch import symbolic as sym
from fiat_tpu_torch.symbolic import UnknownPointSet

RTOL = 1e-13

CONTRACTIONS = [
    ("ij,jk,kl->il", [(8, 16), (16, 32), (32, 4)]),
    ("ij,jk,kl", [(8, 16), (16, 32), (32, 4)]),
    ("ab,bc,cd,de->ae", [(3, 30), (30, 2), (2, 40), (40, 5)]),
    ("iq,jq,q->ij", [(10, 20), (12, 20), (20,)]),
    ("qi,qj,q,qk->ijk", [(50, 6), (50, 7), (50,), (50, 3)]),
    ("abc,cd,bd->a", [(5, 6, 7), (7, 8), (6, 8)]),
    ("ij,jk->ik", [(9, 4), (4, 11)]),
    ("ii->i", [(6, 6)]),
    ("...i,i->...", [(3, 4, 5), (5,)]),
]


@pytest.mark.parametrize("subscripts,shapes", CONTRACTIONS, ids=[c[0] for c in CONTRACTIONS])
def test_contract_matches_fiat_tpu(subscripts, shapes):
    rng = np.random.default_rng(len(subscripts))
    ops = [rng.standard_normal(s) for s in shapes]
    want = np.asarray(jir.contract(subscripts, *ops))
    got = tir.contract(subscripts, *[torch.as_tensor(o) for o in ops])
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= RTOL * max(1.0, np.abs(want).max())
    # numpy operands join the first tensor's device, or go to the device
    # named (all-numpy with none named goes to the card: see
    # test_torch_package's device test)
    assert torch.equal(tir.contract(subscripts, torch.as_tensor(ops[0]), *ops[1:]), got)
    assert torch.equal(tir.contract(subscripts, *ops, device="cpu"), got)


@pytest.mark.parametrize("subscripts,shapes", CONTRACTIONS[:6], ids=[c[0] for c in
                                                                    CONTRACTIONS[:6]])
def test_contract_takes_numpys_optimal_path(subscripts, shapes, monkeypatch):
    rng = np.random.default_rng(7)
    ops = [torch.as_tensor(rng.standard_normal(s)) for s in shapes]
    path = np.einsum_path(subscripts, *[o.numpy() for o in ops], optimize="optimal")[0]
    assert tir.contraction_path(subscripts, *ops) == path
    assert tir.contraction_path(subscripts, *shapes) == path
    calls = []
    einsum = torch.einsum

    def recording(eq, *operands):
        calls.append((eq, len(operands)))
        return einsum(eq, *operands)

    monkeypatch.setattr(torch, "einsum", recording)
    got = tir.contract(subscripts, *ops)
    # one pairwise einsum a step of the path, then the final permutation
    assert [n for _, n in calls] == [len(p) for p in path[1:]] + [1]
    monkeypatch.setattr(torch, "einsum", einsum)
    worst = tir.contract(subscripts, *ops, optimize=["einsum_path"] + [(0, 1)] * (len(ops) - 1))
    assert torch.allclose(got, worst, rtol=1e-12, atol=0)


def test_unconcatenate_matches_fiat_tpu():
    rng = np.random.default_rng(4)
    fused = rng.standard_normal((10, 3))
    pairs = [(("A", [(0, 4, (2, 2)), (4, 6), (6, 10, ())]), fused),
             (("B", [(1, 3)]), fused[:5])]
    want = jir.unconcatenate([(k, np.asarray(v)) for k, v in pairs])
    got = tir.unconcatenate([(k, torch.as_tensor(v)) for k, v in pairs])
    assert [k for k, _ in got] == [k for k, _ in want]
    for (_, g), (_, w) in zip(got, want):
        assert torch.is_tensor(g) and np.array_equal(g.numpy(), np.asarray(w))


def _arith(x, y):
    return x * y + x - y / x


def test_evaluate_and_graph_equal_the_direct_call():
    rng = np.random.default_rng(5)
    x, y = rng.random((4, 5)) + 0.5, rng.random((4, 5))
    direct = _arith(torch.as_tensor(x), torch.as_tensor(y))
    got = tir.evaluate(_arith, x, y, device="cpu")
    assert got.device.type == "cpu" and torch.equal(got, direct)
    gm = tir.as_graph(_arith, x, y)
    assert isinstance(gm, torch.fx.GraphModule)
    assert torch.equal(gm(torch.as_tensor(x), torch.as_tensor(y)), direct)
    text = tir.pprint(lambda t: torch.sin(t) * 2, x)
    assert "aten.sin" in text and "aten.mul" in text
    assert "torch.ops.aten.sin" in tir.lower_text(lambda t: torch.sin(t) * 2, x)


def test_evaluate_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tir.evaluate(_arith, np.ones(3), np.ones(3))


@pytest.mark.parametrize("family,degree", [("Lagrange", 4), ("RaviartThomas", 2),
                                           ("Nedelec", 2)])
def test_symbolic_tensor_path_traces(family, degree):
    """The symbolic tensor path is plain torch: its graph, called on the
    points, and evaluate give the direct call's tables bit for bit."""
    el = getattr(sym, family)(ft.ufc_simplex(2), degree)
    P = np.random.default_rng(8).random((40, 2)) / 2.5

    def tables(p):
        return el.basis_evaluation(1, UnknownPointSet(p, device="cpu"))

    direct = tables(torch.as_tensor(P))
    gm = tir.as_graph(tables, P)
    traced = gm(torch.as_tensor(P))
    evaluated = tir.evaluate(tables, P, device="cpu")
    assert set(traced) == set(direct) == set(evaluated)
    for a in direct:
        assert torch.equal(traced[a], direct[a]) and torch.equal(evaluated[a], direct[a])
    host = el.basis_evaluation(1, sym.PointSet(P))
    assert max(np.abs(direct[a].numpy() - host[a]).max() for a in host) <= 1e-12


CHAIN = [(8, 16), (16, 32), (32, 4)]


def test_cost_analysis_matches_xla_on_products():
    import jax.numpy as jnp
    rng = np.random.default_rng(2)
    a, b, c = (rng.random(s) for s in CHAIN)
    want = jir.cost_analysis(lambda a, b, c: (a @ b) @ c, a, b, c)
    got = tir.cost_analysis(lambda a, b, c: (a @ b) @ c, a, b, c)
    assert got["flops"] == want["flops"] == 2 * (8 * 16 * 32 + 8 * 32 * 4)
    assert got["transcendentals"] == 0.0
    # the bytes of the unfused products: each operand read once, each result written once
    assert got["bytes accessed"] == 8 * (8 * 16 + 16 * 32 + 8 * 32 + 8 * 32 + 32 * 4 + 8 * 4)
    x = rng.random((6, 7))
    assert tir.cost_analysis(lambda x: torch.einsum("ij,kj->ik", x, x), x)["flops"] == \
        jir.cost_analysis(lambda x: jnp.einsum("ij,kj->ik", x, x), x)["flops"]
    v = rng.random(7)
    assert tir.cost_analysis(lambda x, v: x @ v, x, v)["flops"] == \
        jir.cost_analysis(lambda x, v: x @ v, x, v)["flops"]


ELEMENTWISE = [
    ("sin(x) * 2 + 1", lambda m: lambda x, y: m.sin(x) * 2 + 1),
    ("x * y + x - y / x", lambda m: _arith),
    ("exp(x) * cos(y) - x", lambda m: lambda x, y: m.exp(x) * m.cos(y) - x),
    ("sum(x * y)", lambda m: lambda x, y: (x * y).sum()),
    ("sum(x, axis 0) + y[0]", lambda m: lambda x, y: x.sum(0) + y[0]),
]


@pytest.mark.parametrize("name,make", ELEMENTWISE, ids=[e[0] for e in ELEMENTWISE])
def test_cost_analysis_matches_xla_elementwise(name, make):
    import jax.numpy as jnp
    rng = np.random.default_rng(3)
    x, y = rng.random((4, 4)) + 0.5, rng.random((4, 4))
    want = jir.cost_analysis(make(jnp), x, y)
    got = tir.cost_analysis(make(torch), x, y)
    assert got["flops"] == want["flops"], (got, want)
    assert got["transcendentals"] == want.get("transcendentals", 0.0), (got, want)


def test_as_graph_refuses_a_kernel_launch_by_name():
    import ctypes

    def launch(x):
        ctypes.c_void_p(x.data_ptr())          # what a kernel wrapper does on the card
        return x * 2

    with pytest.raises(tir.NotTraceable, match="data_ptr"):
        tir.as_graph(launch, np.ones(3))
    with pytest.raises(tir.NotTraceable, match="host"):
        tir.as_graph(lambda x: x * float(x.sum().item()), np.ones(3))
    with pytest.raises(tir.NotTraceable, match="host"):
        tir.as_graph(lambda x: x * x.numpy().sum(), np.ones(3))
    with pytest.raises(tir.NotTraceable, match="host"):
        tir.as_graph(lambda x: x * np.asarray(x).sum(), np.ones(3))
    with pytest.raises(tir.NotTraceable):
        tir.cost_analysis(launch, np.ones(3))
    assert issubclass(tir.NotTraceable, RuntimeError)


def test_engine_on_the_cpu_traces_its_plain_versions():
    """On the CPU an engine runs its kernels' plain versions, which are
    torch: its trace holds their products and launches nothing."""
    tab = ft.device_tabulator([ft.Lagrange(ft.ufc_simplex(2), 3)], order=1, device="cpu")
    P = np.random.default_rng(9).random((20, 2)) / 2.5
    gm = tir.as_graph(tab.block_tables, P)
    got, want = gm(torch.as_tensor(P)), tab.block_tables(P)
    assert tab.recurrence.launches == 0 and tab.matmul.launches == 0
    assert set(got) == set(want)
    assert all(torch.equal(a, b) for k in want for a, b in zip(got[k], want[k]))
