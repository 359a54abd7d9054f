"""The port's symbolic layer (``fiat_tpu_torch.symbolic``: point sets,
quadrature, the FIAT bridge and the non-zany wrappers) against
``fiat_tpu.symbolic`` on the CPU.

* Every stamped wrapper of the bridge, family x cell x degree 1-3, on
  numpy ``PointSet``s: tables, entity dofs, closure dofs, support dofs,
  mapping, value shape and the dual basis (Q and its merged points), bit
  for bit; constructors that fiat_tpu refuses are refused alike.
* The tensor path: the port on CPU tensors (``UnknownPointSet(...,
  device="cpu")``) against fiat_tpu's traced path under ``jax.jit`` with
  an ``UnknownPointSet``, as tests/test_symbolic.py runs it, at 1e-12 of
  max(1, max |table|) per alpha (one jit per spatial dimension, shared by
  the module); where fiat_tpu's traced path raises (Bernstein, the trace
  element, the interval's Lagrange bases, the hypercube families) the
  port's tensor path is held to the host tables at the same bar.
* The port's counterparts of tests/test_symbolic.py and of
  tests/test_finat_misc.py's dual-point, enriched-dual, facet-support and
  trace-support cases.

Both packages get the same points, made with numpy from seeds;
``from_fiat_tpu_point_set`` hands a fiat_tpu point set to the port."""

from functools import lru_cache

import numpy as np
import pytest
import torch

import fiat_tpu_torch as ft
from fiat_tpu_torch import symbolic as tsym
from fiat_tpu_torch.core import cells as tcl
from fiat_tpu_torch.core.quadrature import GaussLobattoLegendreQuadratureLineRule as TGLL
from fiat_tpu_torch.symbolic import point_set as tps
from fiat_tpu_torch.symbolic.mixed import split_mixed_evaluation as t_split
from fiat_tpu_torch.symbolic.quadrature import make_quadrature as t_make_quadrature

import jax
import jax.numpy as jnp
from fiat_tpu import symbolic as jsym
from fiat_tpu.core import cells as jcl
from fiat_tpu.core.quadrature import GaussLobattoLegendreQuadratureLineRule as JGLL
from fiat_tpu.symbolic import point_set as jps
from fiat_tpu.symbolic.mixed import split_mixed_evaluation as j_split
from fiat_tpu.symbolic.quadrature import make_quadrature as j_make_quadrature

#: the tensor path against fiat_tpu's traced path or the host tables, of
#: max(1, max |table|) per alpha
RTOL_TENSOR = 1e-12
#: the sympy-built families' host tables, of max(1, max |table|): sympy's
#: global cache can reorder an expression tree between the two packages in
#: one process (tests/test_torch_tensor_product.py's RTOL_SYMPY)
RTOL_SYMPY = 1e-14
SYMPY_FAMILIES = ("TrimmedSerendipityEdge", "TrimmedSerendipityFace", "TrimmedSerendipityDiv",
                  "TrimmedSerendipityCurl", "BrezziDouglasMariniCubeEdge",
                  "BrezziDouglasMariniCubeFace")


def from_fiat_tpu_point_set(ps, device=None):
    """The port's point set holding a fiat_tpu point set's points: numpy
    points stay the same numpy arrays, jax arrays become torch tensors on
    ``device`` (an ``UnknownPointSet`` through its own device rule), the
    structure (tensor factors, facet batches, spectral tags) is kept."""
    name = type(ps).__name__
    if name == "TensorPointSet":
        return tps.TensorPointSet(from_fiat_tpu_point_set(f, device) for f in ps.factors)
    if name == "FacetPointSet":
        cell = getattr(tcl, type(ps.cell).__name__)()
        return tps.FacetPointSet(cell, from_fiat_tpu_point_set(ps.ps, device))
    if name == "UnknownPointSet":
        return tps.UnknownPointSet(torch.as_tensor(np.asarray(ps.points)), device=device)
    if name == "PointSingleton":
        return tps.PointSingleton(np.asarray(ps.point))
    pts = ps.points
    if not isinstance(pts, np.ndarray):
        pts = torch.as_tensor(np.asarray(pts), device=device or "cpu")
    return getattr(tps, name)(pts)


def _cells(m):
    return {"I": m.ufc_simplex(1), "T": m.ufc_simplex(2), "S": m.ufc_simplex(3),
            "Q": m.UFCQuadrilateral(), "H": m.UFCHexahedron()}


TCELLS, JCELLS = _cells(tcl), _cells(jcl)

SIMPLICIAL = ["Regge", "HellanHerrmannJohnson", "GopalakrishnanLedererSchoberlFirstKind",
              "GopalakrishnanLedererSchoberlSecondKind", "Bernstein", "Bubble", "FacetBubble",
              "CrouzeixRaviart", "Lagrange", "DiscontinuousLagrange", "Histopolation",
              "DiscontinuousTaylor", "HDivTrace", "RaviartThomas", "BrezziDouglasMarini",
              "BrezziDouglasFortinMarini", "Nedelec", "NedelecSecondKind", "Real"]
CUBICAL = ["Serendipity", "DPC", "TrimmedSerendipityEdge", "TrimmedSerendipityFace",
           "TrimmedSerendipityDiv", "TrimmedSerendipityCurl", "BrezziDouglasMariniCubeEdge",
           "BrezziDouglasMariniCubeFace"]
WRAPPERS = ([(f, c, d) for f in SIMPLICIAL for c in "ITS" for d in (1, 2, 3)]
            + [(f, c, d) for f in CUBICAL for c in "QH" for d in (1, 2, 3)])


def _build(family, cell, degree):
    """(port element, fiat_tpu element), or the error both raise."""
    try:
        j = getattr(jsym, family)(JCELLS[cell], degree)
    except Exception as err:   # noqa: BLE001 - the port must refuse alike
        with pytest.raises(type(err)):
            getattr(tsym, family)(TCELLS[cell], degree)
        return None
    return getattr(tsym, family)(TCELLS[cell], degree), j


def _points(cell, n, seed):
    """n points inside a cell: the unit box, or a corner of the simplex."""
    sd = TCELLS[cell].get_spatial_dimension()
    pts = np.random.default_rng(seed).random((n, sd))
    return pts if cell in "QH" else pts / (sd + 0.5)


def _plain(x):
    if isinstance(x, dict):
        return {_plain(k): _plain(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_plain(v) for v in x)
    if isinstance(x, np.integer):
        return int(x)
    return x


def _same_tables(a, b):
    """Bit for bit, exceptions by type name."""
    assert set(a) == set(b)
    for alpha in b:
        if isinstance(b[alpha], Exception):
            assert type(a[alpha]).__name__ == type(b[alpha]).__name__, alpha
        else:
            assert np.array_equal(np.asarray(a[alpha]), np.asarray(b[alpha]), equal_nan=True), alpha


def _close(mine, ref, rtol=RTOL_TENSOR):
    """Tables (tensors, jax or numpy) within rtol of max(1, max |ref|)."""
    assert set(mine) == set(ref)
    for alpha in ref:
        if isinstance(ref[alpha], Exception):
            assert type(mine[alpha]).__name__ == type(ref[alpha]).__name__, alpha
            continue
        x = mine[alpha].cpu().numpy() if torch.is_tensor(mine[alpha]) else np.asarray(mine[alpha])
        y = np.asarray(ref[alpha])
        assert x.shape == y.shape, alpha
        assert np.abs(x - y).max() <= rtol * max(1.0, np.abs(y).max()), alpha


def _outcome(call):
    """call()'s value as plain Python, or the name of what it raised."""
    try:
        return _plain(call())
    except Exception as err:   # noqa: BLE001 - both packages must agree
        return type(err).__name__


def _dual(el):
    try:
        Q, ps = el.dual_basis
    except NotImplementedError as err:
        return type(err).__name__
    return Q, ps.points


@pytest.mark.parametrize("family,cell,degree", WRAPPERS,
                         ids=[f"{f}-{c}-{d}" for f, c, d in WRAPPERS])
def test_stamped_wrapper_bit_for_bit(family, cell, degree):
    pair = _build(family, cell, degree)
    if pair is None:
        return
    t, j = pair
    pts = _points(cell, 11, degree)
    mine, ref = t.basis_evaluation(1, tps.PointSet(pts)), j.basis_evaluation(1, jps.PointSet(pts))
    if family in SYMPY_FAMILIES:
        _close(mine, ref, rtol=RTOL_SYMPY)
    else:
        _same_tables(mine, ref)
    assert _plain(t.entity_dofs()) == _plain(j.entity_dofs())
    assert _plain(t.entity_closure_dofs()) == _plain(j.entity_closure_dofs())
    assert _outcome(t.entity_support_dofs) == _outcome(j.entity_support_dofs)
    assert t.mapping == j.mapping and t.value_shape == j.value_shape
    assert t.index_shape == j.index_shape and t.space_dimension() == j.space_dimension()
    assert t.formdegree == j.formdegree and t.degree == j.degree
    assert t.is_dg() == j.is_dg()
    td, jd = _dual(t), _dual(j)
    if isinstance(jd, str):
        assert td == jd
    else:
        assert np.array_equal(td[0], jd[0]) and np.array_equal(td[1], jd[1])
    assert t.has_pointwise_dual_basis == j.has_pointwise_dual_basis


# -- the tensor path -----------------------------------------------------------------

#: (family, cell, degree) whose traced path runs in fiat_tpu, and macro ones
TRACED = ([(f, "T", 3) for f in SIMPLICIAL
           if f not in ("Bernstein", "HDivTrace", "Histopolation")]
          + [(f, "S", 2) for f in ("Lagrange", "RaviartThomas", "Nedelec", "Regge",
                                   "NedelecSecondKind", "BrezziDouglasFortinMarini",
                                   "DiscontinuousTaylor")]
          + [("FacetBubble", "S", 3)]
          + [(f, "I", 2) for f in ("Regge", "DPC", "DiscontinuousTaylor", "RaviartThomas")])
#: the macro elements of tests/test_symbolic.py:216 and beside it
MACRO = {"HCT-T-3": lambda m, c: m.HsiehCloughTocher(c["T"], 3),
         "P2-alfeld-T": lambda m, c: m.Lagrange(c["T"], 2, variant="alfeld"),
         "P2-WF-S": lambda m, c: m.Lagrange(c["S"], 2, variant="worsey-farin")}


def _traced_key(case):
    return case if isinstance(case, str) else "%s-%s-%d" % case


def _traced_pair(case):
    if isinstance(case, str):
        import fiat_tpu.elements as jfe
        return (tsym.FiatElement(MACRO[case](ft, TCELLS)),
                jsym.FiatElement(MACRO[case](jfe, JCELLS)))
    f, c, d = case
    return getattr(tsym, f)(TCELLS[c], d), getattr(jsym, f)(JCELLS[c], d)


@lru_cache(maxsize=None)
def _traced_tables():
    """fiat_tpu's traced tables of every TRACED / MACRO case, order 1,
    from one jit per spatial dimension; {key: (port element, tables, pts)}."""
    cases = TRACED + list(MACRO)
    groups = {}
    for case in cases:
        t, j = _traced_pair(case)
        sd = j.cell.get_spatial_dimension()
        groups.setdefault(sd, []).append((_traced_key(case), t, j))
    out = {}
    for sd, members in groups.items():
        pts = np.random.default_rng(10 + sd).random((23, sd)) / (sd + 0.5)

        @jax.jit
        def run(p, members=members):
            return [j.basis_evaluation(1, jps.UnknownPointSet(p)) for _, _, j in members]

        for (key, t, _), tabs in zip(members, run(jnp.asarray(pts))):
            out[key] = (t, {a: np.asarray(v) for a, v in tabs.items()}, pts)
    return out


@pytest.mark.parametrize("case", TRACED + list(MACRO), ids=map(_traced_key, TRACED + list(MACRO)))
def test_tensor_path_vs_fiat_tpu_traced(case):
    t, ref, pts = _traced_tables()[_traced_key(case)]
    ps = tps.UnknownPointSet(torch.as_tensor(pts), device="cpu")
    mine = t.basis_evaluation(1, ps)
    assert all(v.dtype == torch.float64 and v.device.type == "cpu" for v in mine.values())
    _close(mine, ref)
    # and the host tables: the tensor path is the host's function
    _close(mine, t.basis_evaluation(1, tps.PointSet(pts)))


#: where fiat_tpu's traced path raises: the port's tensor path vs host
UNTRACED = ([("Bernstein", c, d) for c in "ITS" for d in (1, 2, 3)]
            + [(f, "I", d) for f in ("Lagrange", "DiscontinuousLagrange", "Histopolation",
                                     "Real", "Bubble", "FacetBubble") for d in (2, 3)]
            + [(f, c, d) for f in CUBICAL for c, top in (("Q", 3), ("H", 2))
               for d in range(1, top + 1)])


@pytest.mark.parametrize("family,cell,degree", UNTRACED,
                         ids=[f"{f}-{c}-{d}" for f, c, d in UNTRACED])
def test_tensor_path_where_fiat_tpu_has_none(family, cell, degree):
    pair = _build(family, cell, degree)
    if pair is None:
        return
    t, j = pair
    pts = _points(cell, 17, 30 + degree)
    p = jnp.asarray(pts)
    with pytest.raises(Exception):
        jax.jit(lambda q: j.basis_evaluation(1, jps.UnknownPointSet(q)))(p)
    order = min(degree + 1, 3 if cell in "ITS" else 2)   # past the degree where cheap
    mine = t.basis_evaluation(order, tps.UnknownPointSet(torch.as_tensor(pts), device="cpu"))
    _close(mine, j.basis_evaluation(order, jps.PointSet(pts)))


def _facet_points(n, seed):
    """n points on the triangle's edges, a third on each."""
    rng = np.random.default_rng(seed)
    s = rng.random(n)
    ends = np.array([[[0, 1], [1, 0]], [[0, 0], [0, 1]], [[0, 0], [1, 0]]], dtype=float)
    e = np.arange(n) % 3
    return ends[e, 0] * (1 - s)[:, None] + ends[e, 1] * s[:, None]


@pytest.mark.parametrize("degree", [0, 1, 3])
def test_trace_tensor_path(degree):
    """The trace element on tensor points: binned to the edges on the
    device, a named edge, and NaN values off the edges, as the host."""
    t, j = tsym.HDivTrace(TCELLS["T"], degree), jsym.HDivTrace(JCELLS["T"], degree)
    pts = _facet_points(30, degree)
    tp = lambda x: tps.UnknownPointSet(torch.as_tensor(x), device="cpu")  # noqa: E731
    _close(t.basis_evaluation(1, tp(pts)), j.basis_evaluation(1, jps.PointSet(pts)))
    edge = np.random.default_rng(degree).random((7, 1))
    _close(t.basis_evaluation(1, tp(edge), entity=(1, 2)),
           j.basis_evaluation(1, jps.PointSet(edge), entity=(1, 2)))
    inside = _points("T", 5, degree)
    mine, ref = t.basis_evaluation(0, tp(inside)), j.basis_evaluation(0, jps.PointSet(inside))
    assert torch.isnan(mine[(0, 0)]).all() and np.isnan(ref[(0, 0)]).all()
    vertex = np.zeros((3, 0))
    _same_kinds(t.basis_evaluation(0, tp(vertex), entity=(0, 1)),
                j.basis_evaluation(0, jps.PointSet(vertex), entity=(0, 1)))


def _same_kinds(a, b):
    assert {k: type(v).__name__ for k, v in a.items()} == \
        {k: type(v).__name__ for k, v in b.items()}


def test_tensor_path_on_entities_and_in_float32():
    """Facet and vertex entities through the affine transform on the
    device; float32 points tabulate in float32."""
    t, j = tsym.Lagrange(TCELLS["S"], 3), jsym.Lagrange(JCELLS["S"], 3)
    pts2 = _points("T", 13, 4)
    for entity in [(2, 0), (2, 3), (1, 4)]:
        p = pts2 if entity[0] == 2 else pts2[:, :1]
        _close(t.basis_evaluation(1, tps.UnknownPointSet(torch.as_tensor(p), device="cpu"),
                                  entity=entity),
               j.basis_evaluation(1, jps.PointSet(p), entity=entity))
    pts = _points("S", 9, 5)
    f32 = t.basis_evaluation(1, tps.UnknownPointSet(torch.as_tensor(pts, dtype=torch.float32),
                                                    device="cpu"))
    assert all(v.dtype == torch.float32 for v in f32.values())
    _close(f32, j.basis_evaluation(1, jps.PointSet(pts)), rtol=1e-5)


def test_unknown_point_set_device_rule(monkeypatch):
    """device=None means the card; without one the points set raises,
    naming device="cpu"; host points become float64 tensors."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        tps.UnknownPointSet(np.zeros((2, 2)))
    ps = tps.UnknownPointSet(np.ones((3, 2)), device="cpu")
    assert ps.points.dtype == torch.float64 and ps.points.device.type == "cpu"
    assert ps.points_shape == (3,) and ps.dimension == 2
    assert ps.almost_equal(ps) and not ps.almost_equal(tps.UnknownPointSet(ps.points,
                                                                            device="cpu"))


def test_from_fiat_tpu_point_set_keeps_structure():
    q = j_make_quadrature(jcl.TensorProductCell(jcl.ufc_simplex(1), jcl.ufc_simplex(1)),
                          (3, 2))
    mine = from_fiat_tpu_point_set(q.point_set)
    assert type(mine).__name__ == "TensorPointSet"
    assert [type(f).__name__ for f in mine.factors] == ["GaussLegendrePointSet"] * 2
    assert np.array_equal(mine.points, q.point_set.points)
    tq = t_make_quadrature(tcl.TensorProductCell(tcl.ufc_simplex(1), tcl.ufc_simplex(1)), (3, 2))
    assert mine.almost_equal(tq.point_set, tolerance=0)
    assert np.array_equal(tq.weight_expression, q.weight_expression)
    fps = from_fiat_tpu_point_set(jps.FacetPointSet(jcl.ufc_simplex(2), q.factors[0].point_set))
    assert np.array_equal(fps.points, jps.FacetPointSet(JCELLS["T"],
                                                        q.factors[0].point_set).points)


@pytest.mark.parametrize("cell,degree,scheme", [("I", 5, "default"), ("T", 4, "default"),
                                                ("S", 3, "default"), ("T", 3, "KMV"),
                                                ("I", 4, "lump"), ("Q", 3, "default")])
def test_make_quadrature_bit_for_bit(cell, degree, scheme):
    t, j = t_make_quadrature(TCELLS[cell], degree, scheme), \
        j_make_quadrature(JCELLS[cell], degree, scheme)
    assert type(t).__name__ == type(j).__name__
    assert type(t.point_set).__name__ == type(j.point_set).__name__
    assert np.array_equal(t.point_set.points, j.point_set.points)
    assert np.array_equal(t.weight_expression, j.weight_expression)
    if cell == "I" and scheme == "default":
        assert np.array_equal(t.intrinsic_orientation_permutation_map_tuple[0],
                              j.intrinsic_orientation_permutation_map_tuple[0])


# -- counterparts of tests/test_symbolic.py ------------------------------------------

def test_dual_evaluation_interpolation():
    """test_symbolic.py:43, and on a torch function of the points."""
    t, j = tsym.Lagrange(TCELLS["T"], 3), jsym.Lagrange(JCELLS["T"], 3)

    def f(ps):
        x = ps.points
        return x[:, 0] ** 3 - 2.0 * x[:, 0] * x[:, 1] + 1.0

    dofs = t.dual_evaluation(f)
    assert np.array_equal(dofs, j.dual_evaluation(f))
    tdofs = t.dual_evaluation(lambda ps: f(tps.PointSet(torch.as_tensor(ps.points))))
    assert torch.is_tensor(tdofs) and np.abs(tdofs.numpy() - dofs).max() < 1e-14
    pts = np.random.default_rng(3).random((6, 2)) / 2
    recon = dofs @ t.basis_evaluation(0, tps.PointSet(pts))[(0, 0)]
    assert np.allclose(recon, pts[:, 0] ** 3 - 2.0 * pts[:, 0] * pts[:, 1] + 1.0, atol=1e-11)


def test_spectral_delta():
    """test_symbolic.py:62, also on tensor GLL points."""
    for m, ps_mod, cells, gll in ((tsym, tps, TCELLS, TGLL), (jsym, jps, JCELLS, JGLL)):
        el = m.GaussLobattoLegendre(cells["I"], 4)
        Q = (t_make_quadrature if m is tsym else j_make_quadrature)(cells["I"], 7)
        assert el.basis_evaluation(0, Q.point_set)[(0,)].shape == (5, 4)
        rule = gll(cells["I"], 5)
        assert np.array_equal(el.basis_evaluation(
            0, ps_mod.GaussLobattoLegendrePointSet(rule.get_points()))[(0,)], np.eye(5))
    el = tsym.GaussLobattoLegendre(TCELLS["I"], 4)
    tab = el.basis_evaluation(1, tps.GaussLobattoLegendrePointSet(
        torch.as_tensor(TGLL(TCELLS["I"], 5).get_points())))
    assert torch.equal(tab[(0,)], torch.eye(5, dtype=torch.float64))
    host = el.basis_evaluation(1, tps.PointSet(TGLL(TCELLS["I"], 5).get_points()))
    _close({(1,): tab[(1,)]}, {(1,): host[(1,)]})


def _tp(m, cells):
    return m.TensorProductElement([m.Lagrange(cells["I"], 2),
                                   m.DiscontinuousLagrange(cells["I"], 1)])


@pytest.mark.parametrize("tensor", [False, True])
def test_tensor_product_element(tensor):
    """test_symbolic.py:77 / :94: bit for bit with fiat_tpu on numpy
    points, the tensor path within RTOL_TENSOR; factored points."""
    t, j = _tp(tsym, TCELLS), _tp(jsym, JCELLS)
    assert t.space_dimension() == 6
    pts = np.random.default_rng(5).random((5, 2))
    ref = j.basis_evaluation(2, jps.PointSet(pts))
    if tensor:
        _close(t.basis_evaluation(2, tps.UnknownPointSet(torch.as_tensor(pts), device="cpu")), ref)
    else:
        _same_tables(t.basis_evaluation(2, tps.PointSet(pts)), ref)
    assert _plain(t.entity_dofs()) == _plain(j.entity_dofs())
    assert _plain(t.entity_permutations) == _plain(j.entity_permutations)
    tq, jq = t_make_quadrature(t.cell, (3, 3)), j_make_quadrature(j.cell, (3, 3))
    mine = t.basis_evaluation(0, tq.point_set)[(0, 0)]
    assert mine.shape == (3, 2, 2, 2)
    assert np.array_equal(mine, j.basis_evaluation(0, jq.point_set)[(0, 0)])
    Q, x = t.dual_basis
    jQ, jx = j.dual_basis
    assert np.array_equal(Q, jQ) and np.array_equal(x.points, jx.points)


@pytest.mark.parametrize("tensor", [False, True])
def test_flattened_dimensions_quad(tensor):
    """test_symbolic.py:109."""
    def make(m, cells):
        A = m.GaussLobattoLegendre(cells["I"], 2)
        return m.FlattenedDimensions(m.TensorProductElement([A, A]))
    t, j = make(tsym, TCELLS), make(jsym, JCELLS)
    assert t.cell.get_shape() == tcl.QUADRILATERAL
    assert _plain(t.entity_dofs()) == _plain(j.entity_dofs())
    assert _plain(t.entity_support_dofs()) == _plain(j.entity_support_dofs())
    pts = np.random.default_rng(6).random((4, 2))
    ref = j.basis_evaluation(1, jps.PointSet(pts))
    if tensor:
        _close(t.basis_evaluation(1, tps.UnknownPointSet(torch.as_tensor(pts), device="cpu")), ref)
    else:
        _same_tables(t.basis_evaluation(1, tps.PointSet(pts)), ref)
    host = t.fiat_equivalent.tabulate(1, pts)
    for alpha in host:
        assert np.allclose(np.asarray(ref[alpha]).reshape(host[alpha].shape), host[alpha],
                           atol=1e-12)


@pytest.mark.parametrize("transpose", [False, True])
def test_tensor_finite_element(transpose):
    """test_symbolic.py:125, both layouts, numpy and tensor."""
    t = tsym.TensorFiniteElement(tsym.Lagrange(TCELLS["T"], 2), (2,), transpose)
    j = jsym.TensorFiniteElement(jsym.Lagrange(JCELLS["T"], 2), (2,), transpose)
    assert t.index_shape == j.index_shape and t.value_shape == (2,)
    pts = np.random.default_rng(7).random((5, 2)) / 2
    ref = j.basis_evaluation(1, jps.PointSet(pts))
    _same_tables(t.basis_evaluation(1, tps.PointSet(pts)), ref)
    _close(t.basis_evaluation(1, tps.UnknownPointSet(torch.as_tensor(pts), device="cpu")), ref)
    assert _plain(t.entity_dofs()) == _plain(j.entity_dofs())
    (tQ, tx), (jQ, jx) = t.dual_basis, j.dual_basis
    assert np.array_equal(tQ, jQ) and np.array_equal(tx.points, jx.points)
    f = lambda ps: np.stack([ps.points[:, 0] ** 2, ps.points[:, 1]], axis=-1)  # noqa: E731
    assert np.array_equal(t.dual_evaluation(f), j.dual_evaluation(f))


def _hdiv(m, cells, kind):
    tp = _tp(m, cells) if kind == "HDivElement" else m.TensorProductElement(
        [m.DiscontinuousLagrange(cells["I"], 1), m.Lagrange(cells["I"], 2)])
    return getattr(m, kind)(tp)


@pytest.mark.parametrize("kind", ["HDivElement", "HCurlElement"])
def test_hdiv_hcurl_wrappers(kind):
    """test_symbolic.py:143, and its H(curl) sibling."""
    t, j = _hdiv(tsym, TCELLS, kind), _hdiv(jsym, JCELLS, kind)
    assert t.mapping == j.mapping and t.value_shape == (2,)
    pts = np.random.default_rng(8).random((5, 2))
    ref = j.basis_evaluation(1, jps.PointSet(pts))
    _same_tables(t.basis_evaluation(1, tps.PointSet(pts)), ref)
    _close(t.basis_evaluation(1, tps.UnknownPointSet(torch.as_tensor(pts), device="cpu")), ref)
    host = t.fiat_equivalent.tabulate(0, pts)
    for alpha in host:
        assert np.allclose(np.asarray(ref[alpha]).reshape(host[alpha].shape), host[alpha],
                           atol=1e-12)
    (tQ, tx), (jQ, jx) = t.dual_basis, j.dual_basis
    assert np.array_equal(tQ, jQ) and np.array_equal(tx.points, jx.points)


def test_enriched_and_mixed():
    """test_symbolic.py:160, numpy and tensor points."""
    def make(m, cells):
        mini = m.EnrichedElement([m.Lagrange(cells["T"], 1), m.Bubble(cells["T"], 3)])
        mixed = m.MixedElement([m.Lagrange(cells["T"], 1), m.RaviartThomas(cells["T"], 1)])
        return mini, mixed
    pts = np.random.default_rng(9).random((5, 2)) / 2
    for t, j in zip(make(tsym, TCELLS), make(jsym, JCELLS)):
        assert t.space_dimension() == j.space_dimension() and t.value_shape == j.value_shape
        assert _plain(t.entity_dofs()) == _plain(j.entity_dofs())
        ref = j.basis_evaluation(1, jps.PointSet(pts))
        _same_tables(t.basis_evaluation(1, tps.PointSet(pts)), ref)
        _close(t.basis_evaluation(1, tps.UnknownPointSet(torch.as_tensor(pts), device="cpu")),
               ref)
        host = t.fiat_equivalent.tabulate(0, pts)[(0, 0)]
        assert np.allclose(np.asarray(ref[(0, 0)]).reshape(host.shape), host, atol=1e-12)
        assert _outcome(lambda: t.entity_permutations) == _outcome(lambda: j.entity_permutations)


def test_entity_support_dofs_symbolic():
    """test_symbolic.py:179."""
    from fiat_tpu_torch.core.finite_element import entity_support_dofs as numeric_esd
    el = tsym.Lagrange(TCELLS["T"], 3)
    assert el.entity_support_dofs()[1] == numeric_esd(el.fiat_equivalent, 1)
    assert tsym.entity_support_dofs(el, 1) == jsym.entity_support_dofs(
        jsym.Lagrange(JCELLS["T"], 3), 1)


@pytest.mark.parametrize("domain,expected", [("vertex", 3), ("facet", 9), ("interior", 1)])
def test_restricted(domain, expected):
    """test_symbolic.py:186 and test_finat_misc.py's restriction rows."""
    t = tsym.RestrictedElement(tsym.Lagrange(TCELLS["T"], 3), domain)
    j = jsym.RestrictedElement(jsym.Lagrange(JCELLS["T"], 3), domain)
    assert t.space_dimension() == expected
    pts = np.random.default_rng(0).random((5, 2)) / 2
    _same_tables(t.basis_evaluation(1, tps.PointSet(pts)), j.basis_evaluation(1, jps.PointSet(pts)))
    vec = tsym.RestrictedElement(tsym.TensorFiniteElement(tsym.Lagrange(TCELLS["T"], 3), (2,)),
                                 domain)
    assert vec.index_shape == (expected, 2)


@pytest.mark.parametrize("codim", [0, 1])
def test_quadrature_element(codim):
    """test_symbolic.py:192, and a facet rule."""
    t = tsym.make_quadrature_element(TCELLS["T"], 3, codim=codim)
    j = jsym.make_quadrature_element(JCELLS["T"], 3, codim=codim)
    ps = t._point_set
    assert np.array_equal(ps.points, j._point_set.points)
    assert ps.points_shape == j._point_set.points_shape
    tab = t.basis_evaluation(0, ps)[(0, 0)]
    assert np.array_equal(tab, j.basis_evaluation(0, j._point_set)[(0, 0)])
    assert _plain(t.entity_dofs()) == _plain(j.entity_dofs())
    if codim == 0:
        assert np.array_equal(np.asarray(tab), np.eye(t.space_dimension()))
    with pytest.raises(ValueError, match="Mismatch"):
        t.basis_evaluation(0, tps.UnknownPointSet(torch.as_tensor(ps.points), device="cpu"))


def test_runtime_tabulated():
    """test_symbolic.py:201, with a provider of torch tensors."""
    tables = {}

    def provider(name, shape):
        return tables.setdefault(name, torch.full(shape, 0.5, dtype=torch.float64))

    el = tsym.RuntimeTabulated(TCELLS["I"], 2, variant="mgd", table_provider=provider)
    tab = el.basis_evaluation(1, tps.PointSet(np.array([[0.3], [0.7]])))
    assert tab[(0,)].shape == (3, 2) and torch.is_tensor(tab[(1,)])
    assert "rt_mgd_2_0_0_c_" in tables and "rt_mgd_2_1_0_c_" in tables
    j = jsym.RuntimeTabulated(JCELLS["I"], 2, variant="mgd", continuous=False, restriction="+")
    t = tsym.RuntimeTabulated(TCELLS["I"], 2, variant="mgd", continuous=False, restriction="+")
    assert t.table_name((1,)) == j.table_name((1,)) and t.formdegree == j.formdegree


@pytest.mark.parametrize("x", [[0.31, 0.27], [0.0, 0.5]])
def test_point_evaluation(x):
    """test_symbolic.py:236: a numpy and a tensor coordinate."""
    t, j = tsym.Lagrange(TCELLS["T"], 3), jsym.Lagrange(JCELLS["T"], 3)
    x = np.array(x)
    _same_tables(t.point_evaluation(1, x), j.point_evaluation(1, x))
    traced = t.point_evaluation(1, torch.as_tensor(x))
    _close({a: v.reshape(-1) for a, v in traced.items()},
           {a: np.asarray(v).reshape(-1) for a, v in j.point_evaluation(1, x).items()})


def test_spectral_mass_conditioning():
    """test_symbolic.py:258."""
    for degree in (3, 5):
        el = tsym.GaussLobattoLegendre(TCELLS["I"], degree)
        rule = TGLL(TCELLS["I"], degree + 1)
        phi = np.asarray(el.basis_evaluation(
            0, tps.GaussLobattoLegendrePointSet(rule.get_points()))[(0,)])
        M = phi @ np.diag(rule.get_weights()) @ phi.T
        assert np.abs(M - np.diag(np.diag(M))).max() < 1e-14
        assert np.linalg.cond(M) < 10 ** degree


def test_gll_hex_sum_factorised():
    """test_symbolic.py:276 (BASELINE config 2's hexahedral half), on
    numpy points and on tensor GLL factors."""
    I = TCELLS["I"]
    A = tsym.GaussLobattoLegendre(I, 8)
    tp = tsym.TensorProductElement([A, A, A])
    jA = jsym.GaussLobattoLegendre(JCELLS["I"], 8)
    jtp = jsym.TensorProductElement([jA, jA, jA])
    q = t_make_quadrature(tp.cell, (9, 9, 9))
    tab = np.asarray(tp.basis_evaluation(0, q.point_set)[(0, 0, 0)])
    assert tab.shape == (9, 9, 9, 5, 5, 5)
    jq = j_make_quadrature(jtp.cell, (9, 9, 9))
    assert np.array_equal(tab, jtp.basis_evaluation(0, jq.point_set)[(0, 0, 0)])
    x = TGLL(I, 9).get_points()
    ps1 = tps.GaussLobattoLegendrePointSet(x)
    tab2 = np.asarray(tp.basis_evaluation(0, tps.TensorPointSet([ps1] * 3))[(0, 0, 0)])
    assert np.array_equal(tab2.reshape(9 ** 3, 9 ** 3), np.eye(9 ** 3))
    dev = tps.GaussLobattoLegendrePointSet(torch.as_tensor(x))
    tab3 = tp.basis_evaluation(1, tps.TensorPointSet([dev] * 3))
    assert torch.equal(tab3[(0, 0, 0)].reshape(9 ** 3, 9 ** 3),
                       torch.eye(9 ** 3, dtype=torch.float64))
    host = tp.basis_evaluation(1, tps.TensorPointSet([ps1] * 3))
    _close(tab3, host)
    assert torch.equal(tps.TensorPointSet([dev] * 2).points,
                       torch.as_tensor(tps.TensorPointSet([ps1] * 2).points))


@pytest.mark.parametrize("tensor", [False, True])
def test_unconcatenate_mixed_roundtrip(tensor):
    """test_symbolic.py:318 without the ir half: a MixedElement
    evaluation splits back into the per-subelement evaluations."""
    a, b = tsym.Lagrange(TCELLS["T"], 2), tsym.RaviartThomas(TCELLS["T"], 1)
    m = tsym.MixedElement([a, b])
    pts = np.random.default_rng(0).random((5, 2)) / 2
    ps = tps.UnknownPointSet(torch.as_tensor(pts), device="cpu") if tensor else tps.PointSet(pts)
    tab = m.basis_evaluation(1, ps)
    parts = t_split(m, tab)
    for el, part in zip((a, b), parts):
        for k, v in el.basis_evaluation(1, ps).items():
            assert tuple(part[k].shape) == tuple(v.shape)
            assert (torch.equal(part[k], v) if tensor else np.array_equal(part[k], v)), k
    jm = jsym.MixedElement([jsym.Lagrange(JCELLS["T"], 2), jsym.RaviartThomas(JCELLS["T"], 1)])
    jtab = {k: np.asarray(v) for k, v in jm.basis_evaluation(1, jps.PointSet(pts)).items()}
    for mine, ref in zip(parts, j_split(jm, jtab)):
        _close(mine, ref)


# -- counterparts of tests/test_finat_misc.py ----------------------------------------

def test_dual_point_dedupe():
    """test_finat_misc.py:14."""
    el = tsym.Lagrange(TCELLS["T"], 3)
    Q, ps = el.dual_basis
    pts = np.asarray(ps.points)
    assert len(pts) == len(np.unique(np.round(pts, decimals=7), axis=0))
    assert len(pts) == el.space_dimension()
    jQ, jps_ = jsym.Lagrange(JCELLS["T"], 3).dual_basis
    assert np.array_equal(Q, jQ) and np.array_equal(pts, jps_.points)


def test_enriched_dual_evaluation():
    """test_finat_misc.py:26, on numpy and on a torch function."""
    base = tsym.Lagrange(TCELLS["T"], 3)
    enriched = tsym.NodalEnrichedElement([tsym.RestrictedElement(base, "facet"),
                                          tsym.RestrictedElement(base, "interior")])
    assert enriched.space_dimension() == base.space_dimension()
    dofs = np.asarray(enriched.dual_evaluation(lambda ps: np.ones(ps.points.shape[:-1])))
    assert dofs.shape == (10,) and np.allclose(dofs, 1.0, atol=1e-11)
    jbase = jsym.Lagrange(JCELLS["T"], 3)
    jen = jsym.NodalEnrichedElement([jsym.RestrictedElement(jbase, "facet"),
                                     jsym.RestrictedElement(jbase, "interior")])
    pts = np.random.default_rng(1).random((6, 2)) / 2
    _same_tables(enriched.basis_evaluation(1, tps.PointSet(pts)),
                 jen.basis_evaluation(1, jps.PointSet(pts)))
    tdofs = enriched.dual_evaluation(lambda ps: torch.ones(len(ps.points), dtype=torch.float64))
    assert torch.is_tensor(tdofs) and np.array_equal(tdofs.numpy(), dofs)


@pytest.mark.parametrize("dim", [2, 3])
def test_facet_support_dofs(dim):
    """test_finat_misc.py:87."""
    from fiat_tpu_torch.core.finite_element import entity_support_dofs
    for el, jel in ((tsym.Lagrange(TCELLS["TS"[dim - 2]], 2),
                     jsym.Lagrange(JCELLS["TS"[dim - 2]], 2)),
                    (tsym.RaviartThomas(TCELLS["TS"[dim - 2]], 1),
                     jsym.RaviartThomas(JCELLS["TS"[dim - 2]], 1))):
        esd = el.entity_support_dofs()[dim - 1]
        assert esd == entity_support_dofs(el.fiat_equivalent, dim - 1)
        assert _plain(esd) == _plain(jel.entity_support_dofs()[dim - 1])


def test_hdiv_trace_support():
    """test_finat_misc.py:98."""
    el = tsym.HDivTrace(TCELLS["T"], 2)
    ed = el.entity_dofs()
    dofs = sorted(d for f in sorted(ed[1]) for d in ed[1][f])
    assert dofs == list(range(el.space_dimension()))
    assert _plain(ed) == _plain(jsym.HDivTrace(JCELLS["T"], 2).entity_dofs())


def test_citations_and_cell_tools():
    tsym.cite("Kirby2010")
    from fiat_tpu_torch.symbolic.citations import BIBLIOGRAPHY, recorded_citations
    from fiat_tpu.symbolic.citations import BIBLIOGRAPHY as JBIB
    assert "Kirby2010" in recorded_citations() and BIBLIOGRAPHY == JBIB
    T = TCELLS["T"]
    assert tsym.cell_tools.max_complex({T}) is T
