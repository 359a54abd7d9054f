"""The port's element-description layer (``fiat_tpu_torch.ufl``) against
fiat_tpu's (``fiat_tpu.ufl``): every description is built in both
packages from one spec, and the two are held to equal repr, hash and
metadata.

* Cells, the Sobolev lattice's order, value shapes and pullbacks.
* Every entry of the registry (``ufl_elements``, aliases included) at
  each of its cells and two degrees: the same
  ``canonical_element_description`` tuple, or the same exception.
* repr, hash and equality of simple and composite descriptions (Mixed,
  Vector, Tensor, Enriched, NodalEnriched, Restricted, Broken, HDiv /
  HCurl, WithMapping, TensorProduct, the tensor-product families).
* Hashes stable across processes and ``PYTHONHASHSEED`` (one subprocess
  hashes both packages' descriptions): the factory's cache and any disk
  cache key on them.

The description layer is pure Python; nothing here runs a kernel."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

import fiat_tpu.ufl as jufl
import fiat_tpu_torch.ufl as tufl
from fiat_tpu.ufl.elementlist import ufl_elements as j_elements
from fiat_tpu_torch.ufl.elementlist import ufl_elements as t_elements

REPO = Path(__file__).resolve().parent.parent

CELLNAMES = ("vertex", "interval", "triangle", "tetrahedron", "quadrilateral",
             "hexahedron", "prism", "pyramid")
SPACES = ("H1", "H2", "H3", "L2", "HCurl", "HDiv", "HDivDiv", "HCurlDiv", "HEin", "HInf")


def descriptions(U):
    """(name, description) pairs built from the same specs in the
    description package ``U`` (either package's ``ufl``)."""
    FE = U.FiniteElement
    cg1, rt1 = FE("CG", "triangle", 1), FE("RT", "triangle", 1)
    bubble = FE("B", "triangle", 3)
    interval_tp = U.TensorProductElement(FE("CG", "interval", 1), FE("DG", "interval", 0))
    return [
        ("CG1", cg1),
        ("P alias", FE("P", "triangle", 2)),
        ("DG gll", FE("DG", "triangle", 2, variant="gll")),
        ("DG equispaced", FE("DG", "triangle", 2, variant="equispaced")),
        ("N1div", FE("N1div", "tetrahedron", 1)),
        ("FEEC P- Lambda", FE("P- Lambda", "triangle", 1, form_degree=1)),
        ("Quadrature", FE("Quadrature", "triangle", 3, quad_scheme="default")),
        ("Real", FE("Real", "triangle", 0)),
        ("Argyris", FE("Argyris", "triangle", 5)),
        ("RTCF", FE("RTCF", "quadrilateral", 2)),
        ("NCE", FE("NCE", "hexahedron", 1)),
        ("Q hex", FE("Q", "hexahedron", 2)),
        ("DQ L2 quad", FE("DQ L2", "quadrilateral", 1)),
        ("Bernstein quad", FE("Bernstein", "quadrilateral", 2)),
        ("Mixed", U.MixedElement([cg1, rt1])),
        ("Mixed by *", cg1 * FE("DG", "triangle", 0)),
        ("Vector", U.VectorElement("CG", "triangle", 2)),
        ("Vector dim 3", U.VectorElement(FE("DG", "triangle", 1), dim=3)),
        ("Tensor", U.TensorElement("CG", "triangle", 1)),
        ("Tensor symmetric", U.TensorElement("CG", "triangle", 1, symmetry=True)),
        ("Tensor (2, 3)", U.TensorElement(FE("BDM", "triangle", 2), shape=(2, 3))),
        ("Enriched", cg1 + bubble),
        ("NodalEnriched", U.NodalEnrichedElement(cg1, bubble)),
        ("Restricted facet", FE("CG", "triangle", 3)["facet"]),
        ("Restricted interior", U.RestrictedElement(FE("CG", "triangle", 3), "interior")),
        ("Restricted mixed", U.MixedElement([cg1, rt1])["facet"]),
        ("Restricted vector", U.RestrictedElement(U.VectorElement(cg1), "interior")),
        ("Broken", U.BrokenElement(FE("CG", "triangle", 2))),
        ("HDiv", U.HDivElement(interval_tp)),
        ("HCurl", U.HCurlElement(interval_tp)),
        ("WithMapping", U.WithMapping(rt1, "identity")),
        ("TensorProduct", U.TensorProductElement(FE("CG", "triangle", 2),
                                                 FE("DG", "interval", 1))),
        ("TensorProduct of TP", U.TensorProductElement(interval_tp, FE("CG", "interval", 2))),
    ]


NAMES = [name for name, _ in descriptions(tufl)]


def _pairs():
    return zip(descriptions(jufl), descriptions(tufl))


@pytest.mark.parametrize("cellname", CELLNAMES)
def test_cells(cellname):
    j, t = jufl.as_cell(cellname), tufl.as_cell(cellname)
    assert (repr(t), str(t), hash(t)) == (repr(j), str(j), hash(j))
    assert t.topological_dimension == j.topological_dimension
    assert t.cellname == j.cellname == cellname
    assert t == tufl.as_cell(cellname) and t != jufl.as_cell(cellname)


def test_tensor_product_cells():
    for subs in (("interval", "interval"), ("triangle", "interval"),
                 ("quadrilateral", "interval"), ("interval",) * 3):
        j = jufl.TensorProductCell(*map(jufl.as_cell, subs))
        t = tufl.TensorProductCell(*map(tufl.as_cell, subs))
        assert (repr(t), hash(t), t.topological_dimension) == (
            repr(j), hash(j), j.topological_dimension)
        assert [c.cellname for c in t.sub_cells] == [c.cellname for c in j.sub_cells]


def test_sobolev_ordering():
    """Every pair of named spaces compares alike in both packages."""
    for a in SPACES:
        for b in SPACES:
            ja, jb, ta, tb = (getattr(jufl, a), getattr(jufl, b), getattr(tufl, a),
                              getattr(tufl, b))
            assert (ta < tb, ta <= tb, ta == tb, ta > tb) == (ja < jb, ja <= jb, ja == jb,
                                                                ja > jb), (a, b)
    assert tufl.H2 < tufl.H1 < tufl.L2
    assert max([tufl.H1, tufl.L2]) == tufl.L2
    assert repr(max([tufl.HDiv, tufl.L2])) == repr(max([jufl.HDiv, jufl.L2]))


def _readings(d):
    """A description's metadata, each entry its value or the name of the
    exception reading it raises (both packages raise alike: a product of
    products has no summed superdegree)."""
    def read(fn):
        try:
            return repr(fn())
        except Exception as exc:  # noqa: BLE001 - the exception type is the reading
            return type(exc).__name__
    return [read(lambda: d.reference_value_shape), read(d.value_shape),
            read(lambda: d.sobolev_space), read(d.mapping),
            read(lambda: d.embedded_superdegree), read(lambda: d.embedded_subdegree),
            read(lambda: d.pullback), read(lambda: type(d.pullback).__name__),
            read(lambda: d.pullback.physical_value_shape(d)),
            read(lambda: len(d.sub_elements)), read(d.family), read(d.degree),
            read(d.variant), read(d.quadrature_scheme)]


@pytest.mark.parametrize("name", NAMES)
def test_value_shapes_and_pullbacks(name):
    (_, j), (_, t) = next((p, q) for p, q in _pairs() if q[0] == name)
    assert _readings(t) == _readings(j)


def test_named_pullbacks():
    assert tufl.FiniteElement("RT", "triangle", 1).pullback is tufl.contravariant_piola
    assert tufl.FiniteElement("CG", "triangle", 1).pullback is tufl.identity_pullback
    assert tufl.VectorElement("N1curl", "tetrahedron", 1).pullback.name == "covariant Piola"
    assert sorted(tufl.supported_pullbacks) == sorted(jufl.supported_pullbacks)
    for name in tufl.supported_pullbacks:
        assert repr(tufl.supported_pullbacks[name]) == repr(jufl.supported_pullbacks[name])


def _canonical(module, family, cell, degree, form_degree):
    try:
        return repr(module.canonical_element_description(family, cell, degree, form_degree))
    except Exception as exc:  # noqa: BLE001 - the exception type is the result
        return type(exc).__name__


def test_registry_has_the_same_entries():
    assert list(t_elements) == list(j_elements)
    for key, data in t_elements.items():
        assert repr(data) == repr(j_elements[key]), key


@pytest.mark.parametrize("key", list(t_elements))
def test_canonical_element_description(key):
    """Every registry entry at each of its cells, at its lowest degree and
    one more (the FEEC entries at form
    degrees 0-3): the same tuple (by
    repr) or the same exception in both packages."""
    family, short, rank, sob, mapping, (kmin, kmax), cells = t_elements[key]
    degrees = [kmin if kmin is not None else 1]
    degrees.append(degrees[0] + 1 if kmax is None or degrees[0] + 1 <= kmax else degrees[0])
    checked = 0
    for cell in cells:
        if cell is None:
            continue
        forms = range(4) if "Lambda" in key else [None]
        for degree in degrees:
            for form in forms:
                got = _canonical(tufl, key, cell, degree, form)
                assert got == _canonical(jufl, key, cell, degree, form), (key, cell, degree,
                                                                          form)
                checked += 1
    assert checked > 0 or all(c is None for c in cells)


@pytest.mark.parametrize("name", NAMES)
def test_repr_and_hash_equal(name):
    (_, j), (_, t) = next((p, q) for p, q in _pairs() if q[0] == name)
    assert repr(t) == repr(j)
    assert str(t) == str(j)
    assert t.shortstr() == j.shortstr()
    assert hash(t) == hash(j)
    assert type(t).__name__ == type(j).__name__
    # equality within the port: a rebuilt description is equal and hashes alike
    (_, again), = [(n, d) for n, d in descriptions(tufl) if n == name]
    assert again == t and hash(again) == hash(t)


def test_compositions_and_restrictions():
    FE = tufl.FiniteElement
    cg, b = FE("CG", "triangle", 1), FE("B", "triangle", 3)
    assert isinstance(cg + b, tufl.EnrichedElement)
    assert isinstance(cg * b, tufl.MixedElement)
    assert isinstance(cg["facet"], tufl.RestrictedElement)
    for shape in (1, 2, (2, 3)):
        for sub in (("CG", "triangle", 1), ("BDM", "triangle", 2)):
            elem = FE(*sub)
            wrap = ((lambda e: tufl.VectorElement(e, dim=shape)) if isinstance(shape, int)
                    else (lambda e: tufl.TensorElement(e, shape=shape)))
            assert (tufl.RestrictedElement(wrap(elem), "interior")
                    == wrap(tufl.RestrictedElement(elem, "interior")))
    subs = [FE("CG", "triangle", 1), FE("BDM", "triangle", 2)]
    assert tufl.MixedElement(subs)["facet"] == tufl.MixedElement([e["facet"] for e in subs])
    assert FE("P", "triangle", 2).family() == "Lagrange"
    assert FE("N1div", "tetrahedron", 1).family() == "Raviart-Thomas"
    for bad in (("NoSuchFamily", "triangle", 1), ("Morley", "triangle", 3)):
        for U in (tufl, jufl):
            with pytest.raises(ValueError):
                U.FiniteElement(*bad)


def test_hashes_stable_across_processes():
    """One subprocess, under another PYTHONHASHSEED, hashes every
    description of both packages: the same integers as here."""
    code = ("import sys; sys.path.insert(0, {repo!r}); sys.path.insert(0, {tests!r})\n"
            "import os; os.environ['JAX_PLATFORMS'] = 'cpu'\n"
            "import fiat_tpu.ufl as j, fiat_tpu_torch.ufl as t\n"
            "from test_torch_ufl import descriptions\n"
            "print([hash(d) for _, d in descriptions(j)])\n"
            "print([hash(d) for _, d in descriptions(t)])\n").format(
                repo=str(REPO), tests=str(REPO / "tests"))
    seed = "1" if os.environ.get("PYTHONHASHSEED") != "1" else "2"
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, PYTHONHASHSEED=seed), cwd=REPO)
    assert out.returncode == 0, out.stderr[-2000:]
    lines = out.stdout.strip().splitlines()[-2:]
    here = [hash(d) for _, d in descriptions(tufl)]
    assert lines[0] == lines[1] == str(here)
    assert len(set(here)) == len(here)
