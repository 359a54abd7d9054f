"""The rest of core in the port (fiat_tpu_torch) against fiat_tpu: the
functional classes ported last (point normal / tangential / second
derivatives, moments of divergence and of normal and tangential traces,
the Legendre normal and tangential moments), the Grundmann-Moller rules,
the Intrepid cells and ``macro.facet_support``, all bit for bit, and the
functionals' readings on a tabulated element to 1e-14."""

import numpy as np
import pytest

import fiat_tpu as jft
import fiat_tpu_torch as tft
from fiat_tpu.core import cells as jcl
from fiat_tpu.core import functionals as jfn
from fiat_tpu.core import macro as jmacro
from fiat_tpu.core import polyset as jps
from fiat_tpu.core.quadrature_schemes import create_quadrature as jcreate
from fiat_tpu_torch.core import cells as tcl
from fiat_tpu_torch.core import functionals as tfn
from fiat_tpu_torch.core import macro as tmacro
from fiat_tpu_torch.core import polyset as tps
from fiat_tpu_torch.core.quadrature_schemes import create_quadrature as tcreate

#: the functionals' readings on a tabulated element: one numpy sum over
#: tables that agree to round-off
EVAL_TOL = 1e-14

NEW_FUNCTIONALS = (
    "PointNormalEvaluation", "PointTangentialDerivative", "PointSecondDerivative",
    "PointNormalSecondDerivative", "PointTangentialSecondDerivative",
    "IntegralMomentOfDivergence", "IntegralMomentOfNormalEvaluation",
    "IntegralMomentOfScaledNormalEvaluation", "IntegralMomentOfTangentialEvaluation",
    "IntegralMomentOfEdgeTangentEvaluation", "IntegralMomentOfFaceTangentEvaluation",
    "IntegralLegendreNormalMoment", "IntegralLegendreTangentialMoment",
    "IntegralLegendreTangentialTangentialMoment")


def _args(name, ns, cell, create):
    """fiat_tpu's arguments for functional ``name`` on ``cell`` in the
    namespace ``ns`` (the cells module and ``create_quadrature`` of one
    package); the same numbers for both packages."""
    sd = cell.get_spatial_dimension()
    pt = tuple(np.linspace(0.15, 0.3, sd))
    s1, s2 = np.linspace(0.5, 1.5, sd), np.linspace(-1.0, 0.7, sd)
    facet = sd                     # the last facet
    if name in ("PointNormalEvaluation", "PointTangentialDerivative",
                "PointNormalSecondDerivative", "PointTangentialSecondDerivative"):
        return (cell, min(facet, sd), pt) if "Tangential" not in name else (cell, 0, pt)
    if name == "PointSecondDerivative":
        return (cell, s1, s2, pt)
    if name == "IntegralMomentOfDivergence":
        Q = create(cell, 4)
        x = np.asarray(Q.get_points())
        return (cell, Q, 1.0 + x.sum(axis=1) ** 2)
    if name in ("IntegralMomentOfNormalEvaluation", "IntegralMomentOfScaledNormalEvaluation",
                "IntegralMomentOfTangentialEvaluation", "IntegralMomentOfFaceTangentEvaluation"):
        Q = create(ns.ufc_simplex(sd - 1), 4)
        x = np.asarray(Q.get_points()).reshape(len(Q.get_weights()), -1)
        P = 1.0 + 2.0 * x.sum(axis=1)
        if name == "IntegralMomentOfFaceTangentEvaluation":
            P = np.stack([P, P ** 2, 1.0 - P])
        return (cell, Q, P, facet)
    if name == "IntegralMomentOfEdgeTangentEvaluation":
        Q = create(ns.ufc_simplex(1), 4)
        return (cell, Q, 1.0 - 3.0 * np.asarray(Q.get_points())[:, 0], 1 if sd > 1 else 0)
    if name.startswith("IntegralLegendre"):
        return (cell, 1 if sd > 1 else 0, 2, 6)
    raise KeyError(name)


def _pair(name, sd):
    """(port functional or its exception, fiat_tpu functional or its
    exception) for ``name`` on the UFC simplex of dimension ``sd``."""
    out = []
    for fn, cl, create in ((tfn, tcl, tcreate), (jfn, jcl, jcreate)):
        cell = cl.ufc_simplex(sd)
        try:
            out.append(getattr(fn, name)(*_args(name, cl, cell, create)))
        except Exception as exc:    # noqa: BLE001 - the same refusal on both sides
            out.append(exc)
    return out


def _same_dict(a, b):
    assert list(a) == list(b)
    for k in a:
        assert len(a[k]) == len(b[k])
        for x, y in zip(a[k], b[k]):
            assert len(x) == len(y)
            assert float(x[0]) == float(y[0]) and tuple(x[1:]) == tuple(y[1:]), (k, x, y)


def _reading(ell, el):
    """ell applied to every basis function of ``el``: the element tabulated
    at ell's points to its derivative order, summed over ell's terms."""
    tabs = el.tabulate(ell.max_deriv_order, ell.points)
    shape = el.value_shape()
    out = 0.0
    for k in range(len(ell.weights)):
        tab = np.asarray(tabs[tuple(int(a) for a in ell.alphas[k])])
        tab = tab.reshape((tab.shape[0], int(np.prod(shape, dtype=int)), tab.shape[-1]))
        out = out + ell.weights[k] * tab[:, ell.comps[k], ell.pt_ids[k]]
    return out


@pytest.mark.parametrize("sd", [1, 2, 3])
@pytest.mark.parametrize("name", NEW_FUNCTIONALS)
def test_functional_matches_fiat_tpu(name, sd):
    """Terms, dict views, target shape and type tag bit for bit, and the
    Riesz representer on an orthonormal polynomial set of the target
    shape; where fiat_tpu refuses the cell, the port refuses it alike."""
    got, want = _pair(name, sd)
    if isinstance(want, Exception):
        assert type(got) is type(want), (got, want)
        return
    assert not isinstance(got, Exception), got
    assert type(got).__name__ == type(want).__name__
    assert got.target_shape == want.target_shape
    assert got.get_type_tag() == want.get_type_tag() and got.tostr() == want.tostr()
    assert got.max_deriv_order == want.max_deriv_order
    for attr in ("points", "pt_ids", "alphas", "comps", "weights"):
        assert np.array_equal(getattr(got, attr), np.asarray(getattr(want, attr))), attr
    # (the face tangent moment on a triangle crosses 2-vectors into scalars:
    # its views fail in fiat_tpu, and must fail alike in the port)
    views = [_outcome(lambda f=f: (f.pt_dict, f.deriv_dict)) for f in (got, want)]
    assert views[0][0] == views[1][0]
    if views[1][0] is not None:
        return
    _same_dict(got.pt_dict, want.pt_dict)
    _same_dict(got.deriv_dict, want.deriv_dict)
    degree = 3
    tset = tps.ONPolynomialSet(tcl.ufc_simplex(sd), degree, shape=got.target_shape)
    jset = jps.ONPolynomialSet(jcl.ufc_simplex(sd), degree, shape=want.target_shape)
    assert np.array_equal(got.to_riesz(tset), np.asarray(want.to_riesz(jset)))


def _outcome(fn):
    """(None, value) or (the exception's type, None)."""
    try:
        return None, fn()
    except Exception as exc:    # noqa: BLE001
        return type(exc), None


def _readable():
    """The (name, sd) whose fiat_tpu functional has working dict views and
    a target shape some element has: () (Lagrange) or (sd,) with sd > 1
    (Raviart-Thomas)."""
    out = []
    for name in NEW_FUNCTIONALS:
        for sd in (1, 2, 3):
            cell = jcl.ufc_simplex(sd)
            err, ell = _outcome(lambda: getattr(jfn, name)(*_args(name, jcl, cell, jcreate)))
            if (err is None and _outcome(lambda: ell.pt_dict)[0] is None
                    and (ell.target_shape == () or (ell.target_shape == (sd,) and sd > 1))):
                out.append((name, sd))
    return out


@pytest.mark.parametrize("name,sd", _readable())
def test_functional_reading_on_a_tabulated_element(name, sd):
    """ell(phi_i) for every basis function of an element of the target
    shape (Lagrange 3 for scalars, RT 2 for vectors), port vs fiat_tpu."""
    got, want = _pair(name, sd)
    if got.target_shape == ():
        tel, jel = (ns.Lagrange(ns.ufc_simplex(sd), 3) for ns in (tft, jft))
    else:
        tel, jel = (ns.RaviartThomas(ns.ufc_simplex(sd), 2) for ns in (tft, jft))
    a, b = _reading(got, tel), _reading(want, jel)
    assert a.shape == b.shape
    assert np.abs(a - b).max() <= EVAL_TOL * max(1.0, np.abs(b).max())


def test_the_functional_names_agree_with_fiat_tpu():
    """Every functional class and helper of fiat_tpu's module is in the
    port's, and no other."""
    def names(mod):
        return {n for n, v in vars(mod).items()
                if not n.startswith("__") and getattr(v, "__module__", None) == mod.__name__}
    assert names(tfn) == names(jfn)
    assert set(NEW_FUNCTIONALS) <= names(tfn)


def test_the_cell_and_macro_names_agree_with_fiat_tpu():
    def names(mod):
        return {n for n, v in vars(mod).items()
                if not n.startswith("_") and getattr(v, "__module__", None) == mod.__name__}
    assert names(tcl) == names(jcl)
    assert names(tmacro) == names(jmacro)
    assert tcl.volume is tcl.simplex_volume


GM_DEGREES = (0, 1, 2, 3, 5, 8, 11, 21, 25, 26)


@pytest.mark.parametrize("sd", [1, 2, 3])
@pytest.mark.parametrize("degree", GM_DEGREES)
def test_grundmann_moller_rule_matches_fiat_tpu(sd, degree):
    """The "gm" rules (the degrees of fiat_tpu's own GM tests) bit for bit,
    under both names of the scheme."""
    for scheme in ("gm", "grundmann_moller"):
        got = tcreate(tcl.ufc_simplex(sd), degree, scheme)
        want = jcreate(jcl.ufc_simplex(sd), degree, scheme)
        assert np.array_equal(got.get_points(), np.asarray(want.get_points()))
        assert np.array_equal(got.get_weights(), np.asarray(want.get_weights()))


@pytest.mark.parametrize("name", ["IntrepidTriangle", "IntrepidTetrahedron"])
def test_intrepid_cells_match_fiat_tpu(name):
    got, want = getattr(tcl, name)(), getattr(jcl, name)()
    assert got.get_vertices() == want.get_vertices()
    assert got.get_topology() == want.get_topology()
    assert got.get_shape() == want.get_shape()
    assert type(got.get_facet_element()).__name__ == type(want.get_facet_element()).__name__
    assert got.get_facet_element().get_topology() == want.get_facet_element().get_topology()
    sd = got.get_spatial_dimension()
    for dim in range(1, sd):
        for e in got.get_topology()[dim]:
            assert np.array_equal(got.compute_tangents(dim, e),
                                  np.asarray(want.compute_tangents(dim, e)))
    for f in got.get_topology()[sd - 1]:
        for m in ("compute_normal", "compute_scaled_normal"):
            assert np.array_equal(getattr(got, m)(f), np.asarray(getattr(want, m)(f))), (m, f)
        assert np.array_equal(got.compute_reference_normal(sd - 1, f),
                              np.asarray(want.compute_reference_normal(sd - 1, f)))
    assert got.volume() == want.volume()
    assert not got.is_macrocell() and got.is_simplex()


def test_ufc_cells_give_their_facet_elements_as_fiat_tpu():
    for sd in (1, 2, 3):
        got, want = tcl.ufc_simplex(sd).get_facet_element(), jcl.ufc_simplex(sd).get_facet_element()
        assert type(got).__name__ == type(want).__name__
        assert got.get_vertices() == want.get_vertices()


@pytest.mark.parametrize("split,sd", [("AlfeldSplit", 2), ("AlfeldSplit", 3),
                                      ("WorseyFarinSplit", 2), ("WorseyFarinSplit", 3),
                                      ("PowellSabinSplit", 2), ("PowellSabinSplit", 3),
                                      ("PowellSabin12Split", 2)])
def test_facet_support_matches_fiat_tpu(split, sd):
    """The parent vertices supporting every facet of a split, from its
    vertices' barycentric coordinates in the parent, bit for bit."""
    tK = getattr(tmacro, split)(tcl.ufc_simplex(sd))
    jK = getattr(jmacro, split)(jcl.ufc_simplex(sd))
    parent = tK.get_parent()
    verts = np.asarray(tK.get_vertices())
    bary = tmacro.xy_to_bary(np.asarray(parent.get_vertices()), verts)
    jbary = jmacro.xy_to_bary(np.asarray(parent.get_vertices()), np.asarray(jK.get_vertices()))
    assert np.array_equal(bary, jbary)
    for f, vs in tK.get_topology()[sd - 1].items():
        got = tmacro.facet_support(bary[list(vs)])
        assert got == jmacro.facet_support(jbary[list(vs)])
        for tol in (1e-12, 0.3):
            assert (tmacro.facet_support(bary[list(vs)], tol)
                    == jmacro.facet_support(jbary[list(vs)], tol))
