"""Serendipity and the sympy families of the port against fiat_tpu on the
CPU: ``Serendipity`` 1-6 on the quadrilateral and 1-4 on the hexahedron
(and its degree-1 interval form), the trimmed serendipity families and the
BDM-cube elements with the cases of tests/test_trimmed_serendipity.py, and
``TrimmedSerendipityFace`` on the hexahedron raising ``ValueError`` as
fiat_tpu's does.

Serendipity is held bit for bit (``same_element``); the sympy families'
tables at RTOL_SYMPY of max(1, max |table|) (sympy's global cache, see
tests/test_torch_tensor_product.py), the rest of them bit for bit.  Inputs
are numpy arrays made from seeds and handed to both packages."""

import sys
from pathlib import Path

import numpy as np
import pytest

import fiat_tpu_torch as ft
from fiat_tpu_torch.core import cells as tcl
from fiat_tpu_torch.elements import sympy_vector as tsv

import fiat_tpu.elements as jfe
from fiat_tpu.core import cells as jcl

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
from test_torch_tensor_product import RTOL_SYMPY, same_element  # noqa: E402

RNG = np.random.default_rng(42)
PTS2 = RNG.random((4, 2))
PTS3 = RNG.random((3, 3))


@pytest.mark.parametrize("degree", range(1, 7))
def test_serendipity_on_the_quadrilateral_matches(degree):
    t = ft.Serendipity(tcl.UFCQuadrilateral(), degree)
    j = jfe.Serendipity(jcl.UFCQuadrilateral(), degree)
    same_element(t, j, RNG.random((12, 2)), order=2)
    assert t.degree() == j.degree()
    for e in range(4):
        same_element(t, j, RNG.random((5, 1)), order=1, entity=(1, e))


@pytest.mark.parametrize("degree", range(1, 5))
def test_serendipity_on_the_hexahedron_matches(degree):
    t = ft.Serendipity(tcl.UFCHexahedron(), degree)
    j = jfe.Serendipity(jcl.UFCHexahedron(), degree)
    same_element(t, j, RNG.random((10, 3)))
    for e in range(6):
        same_element(t, j, RNG.random((4, 2)), order=0, entity=(2, e))


def test_serendipity_on_products_and_the_interval():
    I, jI = tcl.ufc_simplex(1), jcl.ufc_simplex(1)
    same_element(ft.Serendipity(tcl.TensorProductCell(I, I), 3),
                 jfe.Serendipity(jcl.TensorProductCell(jI, jI), 3), RNG.random((7, 2)))
    t = ft.Serendipity(I, 3)
    assert type(t).__name__ == "Lagrange"
    same_element(t, jfe.Serendipity(jI, 3), RNG.random((7, 1)))
    with pytest.raises(IndexError):
        ft.Serendipity(tcl.Point(), 1)


SMINUS = ("TrimmedSerendipityEdge", "TrimmedSerendipityFace", "TrimmedSerendipityDiv",
          "TrimmedSerendipityCurl")


@pytest.mark.parametrize("degree", [1, 2, 3])
@pytest.mark.parametrize("name", SMINUS)
def test_sminus_on_the_quadrilateral_matches(name, degree):
    t = getattr(ft, name)(tcl.ufc_hypercube(2), degree)
    j = getattr(jfe, name)(jcl.ufc_hypercube(2), degree)
    same_element(t, j, PTS2, rtol=RTOL_SYMPY)
    assert t.space_dimension() == t.tabulate(0, PTS2)[(0, 0)].shape[0]
    assert t.mapping() == j.mapping() and t.get_formdegree() == j.get_formdegree()
    with pytest.raises(NotImplementedError):
        t.dual_basis()


@pytest.mark.parametrize("degree", [1, 2, 3])
@pytest.mark.parametrize("name", ["TrimmedSerendipityEdge", "TrimmedSerendipityDiv",
                                  "TrimmedSerendipityCurl"])
def test_sminus_on_the_hexahedron_matches(name, degree):
    t = getattr(ft, name)(tcl.ufc_hypercube(3), degree)
    j = getattr(jfe, name)(jcl.ufc_hypercube(3), degree)
    same_element(t, j, PTS3, rtol=RTOL_SYMPY)


def test_sminus_edge_on_the_hexahedron_at_degree_4_matches():
    """Degree 4: fiat_tpu's entity counts follow its basis (105 rows),
    and so do the port's."""
    t = ft.TrimmedSerendipityEdge(tcl.ufc_hypercube(3), 4)
    j = jfe.TrimmedSerendipityEdge(jcl.ufc_hypercube(3), 4)
    same_element(t, j, PTS3[:1], order=0, rtol=RTOL_SYMPY)
    assert t.space_dimension() == 105 == sum(len(ids) for d in t.entity_dofs().values()
                                             for ids in d.values())


@pytest.mark.parametrize("degree", [1, 2, 3])
@pytest.mark.parametrize("name", ["BrezziDouglasMariniCubeEdge", "BrezziDouglasMariniCubeFace"])
def test_bdm_cube_matches(name, degree):
    t = getattr(ft, name)(tcl.ufc_hypercube(2), degree)
    j = getattr(jfe, name)(jcl.ufc_hypercube(2), degree)
    same_element(t, j, PTS2, rtol=RTOL_SYMPY)
    for e in range(4):
        same_element(t, j, RNG.random((3, 1)), order=1, entity=(1, e), rtol=RTOL_SYMPY)


def test_sympy_families_refuse_as_fiat_tpu():
    """The face element lives on quadrilaterals only; degree 0 and the
    hexahedron's BDM-cube raise ValueError, in both packages."""
    cases = [("TrimmedSerendipityFace", 3, 2), ("TrimmedSerendipityEdge", 2, 0),
             ("BrezziDouglasMariniCubeFace", 3, 1), ("BrezziDouglasMariniCubeEdge", 2, 0)]
    for name, sd, degree in cases:
        with pytest.raises(ValueError) as mine:
            getattr(ft, name)(tcl.ufc_hypercube(sd), degree)
        with pytest.raises(ValueError) as theirs:
            getattr(jfe, name)(jcl.ufc_hypercube(sd), degree)
        assert str(mine.value) == str(theirs.value)
    with pytest.raises(ValueError, match="not defined in dimension 3"):
        ft.TrimmedSerendipityFace(tcl.UFCHexahedron(), 2)


def test_sympy_helpers_match():
    import fiat_tpu.elements.sympy_vector as jsv
    assert [tsv.tri(n) for n in range(-1, 6)] == [jsv.tri(n) for n in range(-1, 6)]
    dfac, mid = tsv.cube_geometry(tcl.UFCHexahedron())
    jdfac, jmid = jsv.cube_geometry(jcl.UFCHexahedron())
    assert str(dfac) == str(jdfac) and str(mid) == str(jmid)
