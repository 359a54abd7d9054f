"""``derivs="jets"`` in the port (fiat_tpu_torch) against fiat_tpu: the
plain ``BatchedTabulator`` on the recurrence's Taylor jets at orders 0-2
(``full_zoo``, a tetrahedral zoo, zoos with macro elements, whose
derivative tables take fiat_tpu's ``special_progs`` route past order 0),
and ``device_tabulator(..., derivs="jets")`` key for key: past order 0
fiat_tpu's engines key only the value table (its ``alpha_mats`` is empty
under jets), and so do the port's.  fiat_tpu's Pallas engines run in
interpret mode, as its own tests run them."""

import numpy as np
import pytest
import jax.numpy as jnp

import fiat_tpu as jft
import fiat_tpu_torch as tft
from fiat_tpu.ops import device_tabulator as jdevice_tabulator
from fiat_tpu.ops.tabulate import BatchedTabulator as JBatchedTabulator
from fiat_tpu_torch import device_tabulator
from fiat_tpu_torch.ops.f32_zoo import F32ZooTabulator
from fiat_tpu_torch.ops.fused_zoo import FusedZooTabulator
from fiat_tpu_torch.ops.tabulate import BatchedTabulator
from chip_smoke import merged_macro

#: the tables relative to max(1, max |table|) per alpha (the issue's bar:
#: the jets recurrence and the dmats rows round apart by ~1e-15)
RTOL = 1e-11
#: fiat_tpu's f32 bar for zoos with macro elements, relative to max abs + 1
#: (tests/test_device_ops.py:586-589, as tests/test_torch_f32_zoo.py)
MACRO_F32_TOL = 5e-5


def full_zoo(ns, T):
    """bench.py's full_zoo (:840-862) in either package's namespace."""
    return ([ns.Lagrange(T, p) for p in range(1, 11)]
            + [ns.DiscontinuousLagrange(T, p) for p in range(1, 9)]
            + [ns.RaviartThomas(T, k) for k in range(1, 7)]
            + [ns.Nedelec(T, k) for k in range(1, 7)]
            + [ns.BrezziDouglasMarini(T, k) for k in range(1, 7)]
            + [ns.CubicHermite(T), ns.Morley(T), ns.Argyris(T, 5), ns.Bell(T),
               ns.HsiehCloughTocher(T, 3), ns.QuadraticPowellSabin6(T)])


def tet_zoo(ns, S):
    return [ns.Lagrange(S, 4), ns.DiscontinuousLagrange(S, 2), ns.RaviartThomas(S, 2),
            ns.Nedelec(S, 2)]


def macro_zoo(ns, T):
    """Plain elements beside C0 and C1 macro elements on two splits."""
    return [ns.Lagrange(T, 3), ns.RaviartThomas(T, 2), ns.HsiehCloughTocher(T, 3),
            ns.QuadraticPowellSabin6(T), ns.Lagrange(T, 2, variant="alfeld")]


def macro_tet_zoo(ns, S):
    """Scott-Vogelius pairs of low degree (Alfeld and Worsey-Farin splits)."""
    return [ns.Lagrange(S, 2), ns.Lagrange(S, 2, variant="alfeld"),
            ns.DiscontinuousLagrange(S, 1, variant="alfeld"),
            ns.Lagrange(S, 1, variant="worsey-farin")]


ZOOS = {"full_zoo": (full_zoo, 2), "tet": (tet_zoo, 3), "macro": (macro_zoo, 2),
        "macro_tet": (macro_tet_zoo, 3)}


def _points(n, sd, seed):
    rng = np.random.default_rng(seed)
    pts = rng.random((n, sd))
    return pts / (pts.sum(axis=1)[:, None] + 1e-9) * rng.random((n, 1))


def _zoos(name):
    build, sd = ZOOS[name]
    return build(jft, jft.ufc_simplex(sd)), build(tft, tft.ufc_simplex(sd)), sd


_FIAT_TPU = {}


def _fiat_tpu_jets(name, order, pts):
    """fiat_tpu's jets tables of zoo ``name`` (cached: its XLA programs
    take most of this file's time)."""
    key = (name, order, pts.tobytes())
    if key not in _FIAT_TPU:
        jzoo = _zoos(name)[0]
        jbt = JBatchedTabulator(jzoo, order=order, derivs="jets", matmul="native")
        _FIAT_TPU[key] = jbt, jbt(jnp.asarray(pts))
    return _FIAT_TPU[key]


def _rel(want, got):
    """max over alphas of max |got - want| / max(1, max |want|)."""
    return max(float(np.abs(np.asarray(got[a]) - np.asarray(want[a])).max())
               / max(1.0, float(np.abs(np.asarray(want[a])).max())) for a in want)


@pytest.mark.parametrize("order", [0, 1, 2])
@pytest.mark.parametrize("name", ["full_zoo", "macro", "tet"])
def test_batched_jets_match_fiat_tpu(name, order):
    """Every derivative table of the jets route, fused and per element,
    against fiat_tpu's jets ``BatchedTabulator`` (native matmul) and the
    port's own dmats route; the macro programs exist only at order 0, as
    in fiat_tpu."""
    _, tzoo, sd = _zoos(name)
    pts = _points(120, sd, 3)
    jbt, want = _fiat_tpu_jets(name, order, pts)
    tbt = BatchedTabulator(tzoo, order=order, derivs="jets", device="cpu")
    assert tbt.derivs == "jets" and tbt.alpha_mats == {} == jbt.alpha_mats
    assert len(tbt.macro_programs) == len(jbt.macro_programs)
    got = tbt(pts)
    assert set(got) == set(want)
    assert _rel(want, {a: t.numpy() for a, t in got.items()}) <= RTOL
    for w, g in zip(jbt.unpack(want), tbt.unpack(got)):
        assert set(w) == set(g) and all(tuple(g[a].shape) == np.asarray(w[a]).shape for a in w)
    dmats = BatchedTabulator(tzoo, order=order, device="cpu")(pts)
    assert set(dmats) == set(got)
    assert _rel({a: t.numpy() for a, t in dmats.items()},
                {a: t.numpy() for a, t in got.items()}) <= RTOL


@pytest.mark.parametrize("name,order", [("macro", 2), ("macro_tet", 1)])
def test_batched_jets_macro_elements_match_host(name, order):
    _, tzoo, sd = _zoos(name)
    pts = _points(40, sd, 11)
    tbt = BatchedTabulator(tzoo, order=order, derivs="jets", device="cpu")
    for el, tab in zip(tzoo, tbt.unpack(tbt(pts))):
        host = el.tabulate(order, pts)
        assert set(host) == set(tab)
        assert _rel(host, {a: t.numpy() for a, t in tab.items()}) <= 1e-10


@pytest.mark.parametrize("name,order", [("macro", 0), ("macro", 1), ("macro_tet", 1)])
def test_device_tabulator_jets_matches_fiat_tpu(name, order):
    """``device_tabulator(..., derivs="jets")`` on the CPU (the kernels'
    plain versions) against fiat_tpu's in interpret mode: the same keys
    (past order 0 the value table alone), the same tables, for the f64
    engine and the f32 one."""
    jzoo, tzoo, sd = _zoos(name)
    pts = _points(60, sd, 21 + order)
    jtab = jdevice_tabulator(jzoo, order=order, derivs="jets", matmul="native", interpret=True)
    tab = device_tabulator(tzoo, order=order, derivs="jets", device="cpu")
    assert isinstance(tab, FusedZooTabulator)
    want = jtab.unpack(jtab.block_tables(jnp.asarray(pts)))
    got = tab.unpack(tab.block_tables(pts))
    assert [set(w) for w in want] == [set(g) for g in got]
    if order:
        assert all(set(g) == {(0,) * sd} for g in got)
    assert max(_rel(w, {a: t.numpy() for a, t in g.items()})
               for w, g in zip(want, got)) <= RTOL
    cat_want, cat_got = jtab(jnp.asarray(pts)), tab(pts)
    assert set(cat_want) == set(cat_got)

    jtab32 = jdevice_tabulator(jzoo, order=order, f64=False, derivs="jets",
                               matmul="native", interpret=True)
    tab32 = device_tabulator(tzoo, order=order, f64=False, derivs="jets", device="cpu")
    assert isinstance(tab32, F32ZooTabulator)
    want32, got32 = jtab32.tables(jnp.asarray(pts)), tab32.tables(pts)
    assert set(want32) == set(got32)
    for a in want32:
        w = np.asarray(want32[a])
        assert np.abs(got32[a].numpy() - w).max() <= MACRO_F32_TOL * (np.abs(w).max() + 1.0)


def test_device_tabulator_jets_on_full_zoo_matches_fiat_tpu_batched():
    """The f64 engine under jets at order 1 on full_zoo keys the values,
    which agree with fiat_tpu's jets ``BatchedTabulator``."""
    _, tzoo, _ = _zoos("full_zoo")
    pts = _points(120, 2, 3)
    tab = device_tabulator(tzoo, order=1, derivs="jets", device="cpu")
    assert tab.alphas == [(0, 0)] and merged_macro(tab) is not None
    got = tab(pts)
    want = _fiat_tpu_jets("full_zoo", 1, pts)[1]
    assert set(got) == {(0, 0)}
    assert _rel({(0, 0): want[(0, 0)]}, {(0, 0): got[(0, 0)].numpy()}) <= RTOL


def test_state_and_from_arrays_carry_derivs():
    """Jets reach the engines through the state alone (empty alpha_mats,
    the value programs) and the tabulator's order."""
    _, tzoo, _ = _zoos("macro")
    bt = BatchedTabulator(tzoo, order=1, derivs="jets", device="cpu")
    st = bt.state()
    assert "derivs" not in st and "order" not in st and st["alpha_mats"] == {}
    # the engines take the value programs: bt has none past order 0 under jets
    nprogs = len(BatchedTabulator(tzoo, order=0, device="cpu").macro_programs)
    assert bt.macro_programs == [] and len(st["macro_programs"]) == nprogs == 3
    assert all(p.alphas == [(0, 0)] for p in st["macro_programs"])
    pts = _points(40, 2, 8)
    a = FusedZooTabulator.from_arrays(**st, order=bt.order, device="cpu")
    b = FusedZooTabulator(bt, device="cpu")
    ta, tb = a(pts), b(pts)
    assert set(ta) == set(tb) == {(0, 0)}
    assert np.array_equal(ta[(0, 0)].numpy(), tb[(0, 0)].numpy())
    assert np.abs(ta[(0, 0)].numpy() - bt(pts)[(0, 0)].numpy()).max() <= 1e-12


def test_unknown_derivs_raise():
    _, tzoo, _ = _zoos("tet")
    with pytest.raises(ValueError, match="derivs"):
        BatchedTabulator(tzoo, order=1, derivs="taylor", device="cpu")
    with pytest.raises(ValueError, match="derivs"):
        device_tabulator(tzoo, order=1, derivs="taylor", device="cpu")
