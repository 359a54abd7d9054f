"""The port's element factory (``fiat_tpu_torch.factory``) against
fiat_tpu's (``fiat_tpu.factory``), each fed the same description built in
its own package from one spec.

* The registry sweep of tests/test_ufl_factory.py: every family of the
  description registry at each supported base cell and its two lowest
  degrees, through both factories: the same symbolic class,
  ``space_dimension``, ``entity_dofs``, ``value_shape``, ``index_shape``
  and ``mapping``, and ``fiat_equivalent.tabulate(1, pts)`` equal bit
  for bit; or the same exception type where fiat_tpu's factory raises.
* Every variant branch (spectral, mimetic, the interval ``fdm*`` tables,
  integral / demkowicz, equispaced and point variants, the runtime
  tabulated ones with a ``table_provider``), the quadrilateral and
  hexahedral flattening, the compositions, caching and its ``deps``,
  ``create_base_element`` and the Quadrature family.
* ``chip_smoke.full_zoo_descriptions``: the 42 ``full_zoo`` elements as
  descriptions, converted and put through ``device_tabulator(...,
  device="cpu")``, equal bit for bit to ``full_zoo(T)``'s tables and
  within RTOL_FIAT_TPU of fiat_tpu's ``BatchedTabulator`` on the same
  points.

Everything runs on the CPU (the engines' plain PyTorch versions)."""

import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import fiat_tpu.ufl as jufl
import fiat_tpu_torch as ft
import fiat_tpu_torch.ufl as tufl
from fiat_tpu import factory as jfactory
from fiat_tpu import symbolic as jsym
from fiat_tpu_torch import factory as tfactory
from fiat_tpu_torch.ufl.elementlist import ufl_elements

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))
import chip_smoke  # noqa: E402
from chip_smoke import merged_macro
from test_torch_ufl import descriptions  # noqa: E402

#: the port's f64 engine (plain versions) against fiat_tpu's
#: BatchedTabulator, of max(1, max |table|) per alpha
RTOL_FIAT_TPU = 1e-11
SWEEP_CELLS = ("interval", "triangle", "tetrahedron", "quadrilateral", "hexahedron")
PACKAGES = ((jufl, jfactory), (tufl, tfactory))


def _read(fn):
    """fn()'s value, or the name of the exception it raises."""
    try:
        return fn()
    except Exception as exc:  # noqa: BLE001 - the exception type is the reading
        return type(exc).__name__


def _points(el, n=7, seed=3):
    sd = el.cell.get_spatial_dimension()
    return np.random.default_rng(seed).random((n, sd)) / (sd + 0.5)


def _tables(el):
    """fiat_equivalent.tabulate(1, pts) as numpy (a table that is an
    exception, as the trace element's gradients, by its type's name), or
    the name of the exception tabulate raises."""
    def tab():
        fe = el.fiat_equivalent
        return {a: type(t).__name__ if isinstance(t, Exception) else np.asarray(t)
                for a, t in fe.tabulate(1, _points(el)).items()}
    return _read(tab)


def _summary(el):
    if isinstance(el, str):
        return el
    mapping = getattr(el, "mapping", None)
    return {"class": type(el).__name__,
            "space_dimension": _read(el.space_dimension),
            "entity_dofs": _read(el.entity_dofs),
            "value_shape": _read(lambda: el.value_shape),
            "index_shape": _read(lambda: el.index_shape),
            "mapping": _read(mapping) if callable(mapping) else mapping,
            "degree": _read(lambda: el.degree)}


def _same_tables(want, got):
    if isinstance(want, str) or isinstance(got, str):
        return want == got
    return set(want) == set(got) and all(
        want[a] == got[a] if isinstance(want[a], str) else
        not isinstance(got[a], str) and np.array_equal(want[a], got[a], equal_nan=True)
        for a in want)


def both(build, **kwargs):
    """The element of one spec from each factory: ``build(ufl)`` makes the
    description in a package; returns (fiat_tpu's, the port's), each an
    element or the name of the exception its factory raised."""
    return tuple(_read(lambda ufl=ufl, fac=fac: fac.create_element(build(ufl), **kwargs))
                 for ufl, fac in PACKAGES)


def assert_same(build, tabulate=True, **kwargs):
    j, t = both(build, **kwargs)
    assert _summary(t) == _summary(j)
    if tabulate and not isinstance(j, str):
        assert _same_tables(_tables(j), _tables(t))
    return j, t


def _registry_families():
    seen, out = set(), []
    for data in ufl_elements.values():
        if data[0] not in seen:
            seen.add(data[0])
            out.append(data)
    return out


@pytest.mark.parametrize("data", _registry_families(), ids=lambda d: d[0])
def test_registry_factory_sweep(data):
    """Every registry family at each supported base cell, at its lowest
    degree and one more: both factories convert it alike or raise the
    same exception type."""
    family, short, rank, sob, mapping, (kmin, kmax), cells = data
    degree = kmin if kmin is not None else 1
    degrees = [degree] + ([degree + 1] if kmax is None or degree + 1 <= kmax else [])
    kw = {}
    if family in ("Quadrature", "Boundary Quadrature"):
        kw["quad_scheme"] = "default"
        degrees = [max(d, 1) for d in degrees]
    for cell in SWEEP_CELLS:
        if cell not in cells:
            continue
        for d in degrees:
            j, t = assert_same(lambda U, cell=cell, d=d: U.FiniteElement(family, cell, d, **kw))
            if not isinstance(j, str):
                tiled = sum(len(ids) for ent in t.entity_dofs().values() for ids in ent.values())
                assert tiled == t.space_dimension()


def test_registry_tables_match():
    assert list(tfactory.supported_elements) == list(jfactory.supported_elements)
    for key, make in tfactory.supported_elements.items():
        want = jfactory.supported_elements[key]
        assert (make is None) == (want is None), key
        if make is not None:
            assert make.__name__ == want.__name__, key
    assert {k: v.__name__ for k, v in tfactory.cg_interval_variants.items()} == {
        k: v.__name__ for k, v in jfactory.cg_interval_variants.items()}
    assert sorted(tfactory.dg_interval_variants) == sorted(jfactory.dg_interval_variants)


#: (family, cell, degree, variant): every branch of the Lagrange and
#: discontinuous Lagrange variants, and point variants of other families
VARIANTS = (
    [("CG", "interval", 5, None), ("DG", "interval", 3, None),
     ("CG", "triangle", 3, "spectral"), ("DG", "triangle", 3, "spectral"),
     ("CG", "triangle", 3, "mimetic"), ("DG", "interval", 3, "mimetic"),
     ("DG", "triangle", 2, "mimetic"),
     ("CG", "triangle", 3, "equispaced"), ("DG", "triangle", 3, "equispaced"),
     ("CG", "triangle", 3, "gll"), ("DG", "tetrahedron", 2, "gl"),
     ("CG", "triangle", 2, "alfeld"), ("DG", "triangle", 2, "powell-sabin"),
     ("CG", "tetrahedron", 2, "worsey-farin"), ("CG", "triangle", 1, "iso(2)"),
     ("CG", "triangle", 3, "integral"), ("DG", "triangle", 3, "integral"),
     ("CG", "tetrahedron", 2, "demkowicz"), ("DG", "triangle", 2, "demkowicz"),
     ("CG", "triangle", 3, "fdm"), ("DG", "triangle", 3, "fdm"),
     ("CG", "interval", 4, "integral(1)")]
    + [("CG", "interval", 3, v) for v in ("fdm", "fdm_ipdg", "fdm_quadrature", "fdm_broken",
                                           "fdm_hermite")]
    + [("CG", "interval", 4, "fdm_hermite")]
    + [("DG", "interval", 3, v) for v in ("fdm", "fdm_quadrature", "fdm_ipdg", "fdm_broken")]
    + [("RT", "triangle", 2, "integral"), ("N1curl", "tetrahedron", 2, "point"),
       ("BDM", "triangle", 2, "alfeld"), ("HDiv Trace", "triangle", 2, None),
       ("Bubble", "triangle", 4, None), ("FacetBubble", "triangle", 3, None),
       ("Regge", "triangle", 1, "point")])


#: the VARIANTS both factories refuse (ValueError: the variant does not
#: apply on the cell; FDMHermite is cubic)
REFUSED_VARIANTS = {("DG", "triangle", 2, "mimetic"), ("CG", "tetrahedron", 2, "demkowicz"),
                    ("DG", "triangle", 2, "demkowicz"), ("CG", "triangle", 3, "fdm"),
                    ("DG", "triangle", 3, "fdm"), ("CG", "interval", 4, "fdm_hermite")}


@pytest.mark.parametrize("family,cell,degree,variant", VARIANTS,
                         ids=[f"{f}-{c}-{d}-{v}" for f, c, d, v in VARIANTS])
def test_variant_branches(family, cell, degree, variant):
    j, t = assert_same(lambda U: U.FiniteElement(family, cell, degree, variant=variant))
    assert isinstance(t, str) == ((family, cell, degree, variant) in REFUSED_VARIANTS), t


def test_default_variants_are_the_factorys():
    """A Lagrange description without a variant becomes GaussLobattoLegendre,
    a discontinuous Lagrange one GaussLegendre; equispaced names the
    classes' own Lagrange."""
    sym = ft.symbolic
    assert isinstance(ft.create_element(tufl.FiniteElement("CG", "interval", 5)),
                      sym.GaussLobattoLegendre)
    assert isinstance(ft.create_element(tufl.FiniteElement("DG", "triangle", 3)),
                      sym.GaussLegendre)
    el = ft.create_element(tufl.FiniteElement("CG", "triangle", 2, variant="equispaced"))
    assert type(el) is sym.Lagrange


@pytest.mark.parametrize("variant", ["mgd", "feec", "qb", "mse"])
@pytest.mark.parametrize("family", ["CG", "DG"])
def test_runtime_tabulated(family, variant):
    """The runtime-tabulated variants: the same class, table names and
    tables from the same table_provider; shift_axes and restriction are
    the deps that key the cache."""
    def provider(name, shape):
        return np.arange(np.prod(shape), dtype=float).reshape(shape) + len(name)

    out = []
    for ufl, fac in PACKAGES:
        d = ufl.FiniteElement(family, "interval", 3, variant=variant)
        el, deps = fac._create_element(d, shape_innermost=True, shift_axes=1, restriction="+",
                                       table_provider=provider)
        assert deps == {"shift_axes", "restriction"}
        assert fac.create_element(d, shift_axes=1, restriction="+",
                                  table_provider=provider) is el
        assert fac.create_element(d, shift_axes=0, restriction="+",
                                  table_provider=provider) is not el
        ps = (ft.symbolic if ufl is tufl else jsym).PointSet(np.linspace(0, 1, 4)[:, None])
        out.append((type(el).__name__, el.table_name((1,)), _read(el.entity_dofs),
                    el.space_dimension(), el.basis_evaluation(1, ps)))
    (jc, jn, je, jd, jt), (tc, tn, te, td, tt) = out
    assert (tc, tn, te, td) == (jc, jn, je, jd)
    assert set(tt) == set(jt) and all(np.array_equal(np.asarray(tt[a]), np.asarray(jt[a]))
                                      for a in jt)
    for ufl, fac in PACKAGES:
        with pytest.raises(KeyError):         # convert called without the factory's kwargs
            fac.convert(ufl.FiniteElement(family, "interval", 2, variant=variant))


FLATTENED = [("Q", "quadrilateral", 2), ("DQ", "quadrilateral", 1), ("RTCF", "quadrilateral", 2),
             ("RTCE", "quadrilateral", 1), ("S", "quadrilateral", 2), ("Q", "hexahedron", 1),
             ("DQ", "hexahedron", 2), ("NCF", "hexahedron", 1), ("NCE", "hexahedron", 1),
             ("Real", "quadrilateral", 0), ("Bernstein", "quadrilateral", 2),
             ("DQ L2", "quadrilateral", 1), ("DPC", "quadrilateral", 2),
             ("Bernstein", "hexahedron", 1), ("Real", "hexahedron", 0)]


@pytest.mark.parametrize("family,cell,degree", FLATTENED,
                         ids=[f"{f}-{c}-{d}" for f, c, d in FLATTENED])
def test_quad_and_hex_flattening(family, cell, degree):
    j, t = assert_same(lambda U: U.FiniteElement(family, cell, degree))
    assert not isinstance(t, str)


COMPOSITIONS = [name for name, _ in descriptions(tufl)]


@pytest.mark.parametrize("name", COMPOSITIONS)
def test_compositions(name):
    """test_torch_ufl's descriptions through both factories, each
    converted alike (or refused with the same exception type)."""
    def build(U):
        return dict(descriptions(U))[name]
    assert_same(build)
    assert_same(build, shape_innermost=False)


def test_caching_and_deps():
    for ufl, fac in PACKAGES:
        e1, e2 = (ufl.FiniteElement("Lagrange", "triangle", 3) for _ in range(2))
        assert e1 == e2 and hash(e1) == hash(e2)
        assert fac.create_element(e1) is fac.create_element(e2)
        v = ufl.VectorElement("CG", "triangle", 1)
        a = fac.create_element(v, shape_innermost=True)
        b = fac.create_element(v, shape_innermost=False)
        assert a is not b and fac.create_element(v, shape_innermost=True) is a
    kwargs = dict(shape_innermost=True, shift_axes=0, restriction=None, table_provider=None)
    for name, _ in descriptions(tufl):
        deps = [_read(lambda ufl=ufl, fac=fac: fac._create_element(
            dict(descriptions(ufl))[name], **kwargs)[1]) for ufl, fac in PACKAGES]
        assert deps[0] == deps[1], name
    tp = [_read(lambda ufl=ufl, fac=fac: fac._create_element(
        ufl.TensorProductElement(ufl.FiniteElement("CG", "interval", 1, variant="mgd"),
                                 ufl.FiniteElement("DG", "interval", 0, variant="mgd")),
        **kwargs)[1]) for ufl, fac in PACKAGES]
    assert tp[0] == tp[1] == {"shift_axes", "restriction"}


def test_create_base_element():
    specs = [lambda U: U.VectorElement("CG", "triangle", 2),
             lambda U: U.TensorElement("DG", "triangle", 1, symmetry=True),
             lambda U: U.VectorElement(U.FiniteElement("RT", "triangle", 1), dim=2),
             lambda U: U.FiniteElement("N1curl", "tetrahedron", 1)]
    for build in specs:
        j, t = (fac.create_base_element(build(ufl)) for ufl, fac in PACKAGES)
        assert _summary(t) == _summary(j)
        assert _same_tables(_tables(j), _tables(t))
        assert not isinstance(t, ft.symbolic.TensorFiniteElement)


@pytest.mark.parametrize("family,degree,scheme", [
    ("Quadrature", 3, "default"), ("Quadrature", 4, "KMV"), ("Quadrature", 2, "canonical"),
    ("Boundary Quadrature", 2, "default"), ("Quadrature", None, "default"),
    ("Quadrature", 3, None)])
def test_quadrature_family(family, degree, scheme):
    j, t = assert_same(lambda U: U.FiniteElement(family, "triangle", degree,
                                                 quad_scheme=scheme))
    if not isinstance(t, str):
        assert type(t) is ft.symbolic.QuadratureElement


def test_refusals_match():
    """Where fiat_tpu's factory raises, the port's raises the same type."""
    cases = [
        lambda U: U.FiniteElement("Quadrature", "triangle", None, quad_scheme="default"),
        lambda U: U.FiniteElement("Undefined", "triangle", 1),
        lambda U: U.FiniteElement("AAE", "hexahedron", 1),
        lambda U: U.FiniteElement("Bubble", "triangle", 2),
        lambda U: U.FiniteElement("HDiv Trace", "hexahedron", 1),
        lambda U: U.FiniteElement("Lagrange", None, 1),
        lambda U: U.FiniteElement("Lagrange", "triangle", 2, variant="mgd"),
    ]
    for build in cases:
        j, t = both(build)
        assert isinstance(j, str) and t == j, (j, t)
    for call in (lambda fac: fac.convert(object()), lambda fac: fac.as_fiat_cell("triangle")):
        j, t = (_read(lambda fac=fac: call(fac)) for fac in (jfactory, tfactory))
        assert isinstance(j, str) and t == j, (j, t)


def test_as_fiat_cell():
    for ufl, fac in PACKAGES:
        for cell in (ufl.interval, ufl.triangle, ufl.tetrahedron, ufl.quadrilateral,
                     ufl.hexahedron, ufl.TensorProductCell(ufl.triangle, ufl.interval)):
            ref = fac.as_fiat_cell(cell)
            assert fac.as_fiat_cell(cell) is ref
    for cell in ("interval", "triangle", "tetrahedron", "quadrilateral", "hexahedron"):
        t = tfactory.as_fiat_cell(tufl.as_cell(cell))
        j = jfactory.as_fiat_cell(jufl.as_cell(cell))
        assert type(t).__name__ == type(j).__name__
        assert t.get_spatial_dimension() == j.get_spatial_dimension()
        assert np.array_equal(np.asarray(t.get_vertices()), np.asarray(j.get_vertices()))
        assert type(t).__module__.startswith("fiat_tpu_torch.")


def test_element_factory_reexport():
    from fiat_tpu_torch.symbolic import element_factory
    for name in ("as_fiat_cell", "convert", "create_base_element", "create_element",
                 "supported_elements"):
        assert getattr(element_factory, name) is getattr(tfactory, name)
    assert ft.create_element is tfactory.create_element
    source = (Path(ft.__file__).parent / "symbolic" / "__init__.py").read_text()
    assert "element_factory" not in source


def test_full_zoo_descriptions_through_the_engine():
    """full_zoo as 42 descriptions, converted by the factory and tabulated
    by the f64 engine's plain versions: equal bit for bit to full_zoo(T)'s
    tables, within RTOL_FIAT_TPU of fiat_tpu's BatchedTabulator on the
    factory's elements."""
    import jax.numpy as jnp
    from fiat_tpu.ops.tabulate import BatchedTabulator as JBatchedTabulator

    tdescs = chip_smoke.full_zoo_descriptions(tufl)
    assert len(tdescs) == 42
    zoo = [ft.create_element(d).fiat_equivalent for d in tdescs]
    ref = chip_smoke.full_zoo(ft.ufc_simplex(2))
    assert [type(a) for a in zoo] == [type(b) for b in ref]
    pts = np.random.default_rng(23).random((300, 2)) / 2.5
    tab = ft.device_tabulator(zoo, order=1, device="cpu")
    got = tab.block_tables(pts)
    want = ft.device_tabulator(ref, order=1, device="cpu").block_tables(pts)
    assert set(got) == set(want)
    for k in want:
        assert len(got[k]) == len(want[k])
        assert all(torch.equal(a, b) for a, b in zip(got[k], want[k])), k
    assert tab.recurrence.launches == 0 and tab.matmul.launches == 0
    assert merged_macro(tab) is not None and merged_macro(tab).launches == 0

    jzoo = [jfactory.create_element(d).fiat_equivalent
            for d in chip_smoke.full_zoo_descriptions(jufl)]
    bt = JBatchedTabulator(jzoo, order=1)
    jper = bt.unpack(bt(jnp.asarray(pts)))
    worst = 0.0
    for w, g in zip(jper, tab.unpack(got)):
        assert set(w) == set(g)
        for a in w:
            wa = np.asarray(w[a])
            scale = max(1.0, float(np.abs(wa).max()))
            worst = max(worst, float(np.abs(g[a].numpy() - wa).max()) / scale)
    assert worst <= RTOL_FIAT_TPU, worst
