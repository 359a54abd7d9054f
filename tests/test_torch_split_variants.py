"""The split variants on the port against fiat_tpu: ``IsoSplit`` (vertices,
topology, child-to-parent maps, subcomplexes), the Piola ``pullback``,
``MacroPolynomialSet`` through every family that builds on a split
(RaviartThomas, Nedelec, BrezziDouglasMarini, BrezziDouglasFortinMarini,
CrouzeixRaviart, NedelecSecondKind, Regge, HellanHerrmannJohnson and the
two Gopalakrishnan-Lederer-Schoberl kinds on the Alfeld, Worsey-Farin,
Powell-Sabin, Powell-Sabin(12) and Iso(2) splits; coefficients, entity
dofs and dual terms bit for bit), the iso variants of Lagrange and DG, the
split prefixes of quadrature schemes, the binning masks of the Iso splits,
the refusal of degree-0 macro programs by the engines, and a small split
zoo on each cell through every engine of the port on the CPU (the kernels'
plain versions) against fiat_tpu's engines, its Pallas kernels in
interpret mode as its own tests run them; and chip_smoke.py's two split
zoos (``split_variants_tri``, ``split_variants_tet``).

Inputs are numpy arrays made from seeds and handed to both packages."""

import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fiat_tpu import elements as jfe
from fiat_tpu.core import cells as jcl
from fiat_tpu.core import expansions as jexp
from fiat_tpu.core import macro as jma
from fiat_tpu.core import variants as jva
from fiat_tpu.ops import moments as jmo
from fiat_tpu.ops.pallas_multiword import FusedZooTabulator as JFusedZooTabulator
from fiat_tpu.ops.pallas_tabulate import PallasZooTabulator
from fiat_tpu.ops.tabulate import BatchedTabulator as JBatchedTabulator
import fiat_tpu_torch as ft
from fiat_tpu_torch import device_tabulator
from fiat_tpu_torch.core import cells as tcl
from fiat_tpu_torch.core import expansions as texp
from fiat_tpu_torch.core import macro as tma
from fiat_tpu_torch.core import variants as tva
from fiat_tpu_torch.ops import moments as tmo
from fiat_tpu_torch.ops.tabulate import BatchedTabulator

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))
import chip_smoke  # noqa: E402
from chip_smoke import merged_macro
from test_nodality_sweep import SPECS, _label  # noqa: E402
from test_torch_families import (  # noqa: E402
    _build_fiat, _build_port, _points, _same_element)
from test_torch_many_subcells import _tie_points  # noqa: E402

#: f64 tables vs fiat_tpu's interpreted engine, of max(1, max |table|) per
#: element and alpha: that engine reaches f64 through df32 pairs and is
#: itself up to 5.4e-10 from host where a table reaches 3.4e4 (HHJ 1 on
#: the Powell-Sabin tetrahedron), 1.6e-14 of it; the port reads 7.3e-12
#: from host there
RTOL_ENGINE = 1e-11
ATOL_HOST = 1e-10       # f64 tables vs host el.tabulate
ATOL_DUAL = 1e-12       # moments and interpolation vs fiat_tpu's CPU path
#: the split elements whose moments and interpolated values are held to
#: their table bar (ATOL_HOST) times the sum of |w| (or of |c| over their
#: rows), not ATOL_DUAL, because their readings need it (on 200 points and
#: the tie points, vs fiat_tpu's CPU route, which tabulates the split basis
#: where the port sums in the parent basis: HHJ 1 on the Powell-Sabin
#: tetrahedron 2.6e-11, GLS first kind on Iso(2) 5.5e-12, GLS second kind
#: on Alfeld 2.7e-12; their tables reach 3.4e4, 5.1e2 and 5.8e2)
DUAL_WIDE = (("HellanHerrmannJohnson", 1, "powell-sabin"),
             ("GopalakrishnanLedererSchoberlFirstKind", 1, "iso(2)"),
             ("GopalakrishnanLedererSchoberlSecondKind", 1, "alfeld"))
RTOL_F32 = 5e-6         # fiat_tpu's f32 bar (tests/test_device_ops.py:143-144)
MACRO_TOL = 5e-5        # its macro bar, relative to max abs + 1 (:586-589)

FAMILIES = chip_smoke.SPLIT_FAMILIES + ("BrezziDouglasFortinMarini",)
SPLITS = {2: ("alfeld", "worsey-farin", "powell-sabin", "powell-sabin(12)", "iso(2)"),
          3: ("alfeld", "worsey-farin", "powell-sabin", "iso(2)")}


def _cells(sd):
    return jcl.ufc_simplex(sd), tcl.ufc_simplex(sd)


# -- IsoSplit ------------------------------------------------------------------------

def _same_complex(j, t):
    assert type(t).__name__ == type(j).__name__
    assert np.array_equal(np.asarray(t.get_vertices()), np.asarray(j.get_vertices()))
    assert t.get_topology() == j.get_topology()


@pytest.mark.parametrize("sd,degree", [(2, 2), (2, 3), (3, 2)])
def test_iso_split_matches_fiat_tpu(sd, degree):
    """Vertices, topology, the child <-> parent maps, the interior facets
    and every subcomplex."""
    jT, tT = _cells(sd)
    j, t = jma.IsoSplit(jT, degree), tma.IsoSplit(tT, degree)
    _same_complex(j, t)
    assert t.get_child_to_parent() == j.get_child_to_parent()
    assert t.get_parent_to_children() == j.get_parent_to_children()
    for dim in range(sd + 1):
        assert t.get_interior_facets(dim) == j.get_interior_facets(dim)
        _same_complex(j.construct_subcomplex(dim), t.construct_subcomplex(dim))
    assert len(t.get_topology()[sd]) == degree ** sd


def test_iso_split_of_a_tetrahedron_needs_degree_2_in_both():
    for mod, cells in ((jma, jcl), (tma, tcl)):
        with pytest.raises(NotImplementedError, match="degree 2"):
            mod.IsoSplit(cells.ufc_simplex(3), 3)


def _iso_tie_points(sd, degree=2):
    """Points where the subcells of the Iso(degree) split meet: its
    vertices, points along every edge (those of the reversed central
    triangles and of the octahedron's cut diagonal among them) and, on
    the tetrahedron, the centres of its faces."""
    cell = tma.IsoSplit(tcl.ufc_simplex(sd), degree)
    V = np.asarray(cell.get_vertices())
    top = cell.get_topology()
    pts = [V[a] + t * (V[b] - V[a]) for a, b in top[1].values() for t in (0.25, 0.5)]
    if sd == 3:
        pts += [V[list(f)].mean(axis=0) for f in top[2].values()]
    return np.vstack([V, np.asarray(pts)])


@pytest.mark.parametrize("sd,degree", [(2, 2), (2, 3), (3, 2)])
@pytest.mark.parametrize("unique", [True, False])
def test_iso_binning_masks_equal_fiat_tpu_exactly(sd, degree, unique):
    """Random points and points on the internal facets of the Iso splits
    (whose central triangle is reversed and whose octahedron is cut along
    one diagonal): the same {0,1} masks and cover counts as fiat_tpu's."""
    jT, tT = _cells(sd)
    pts = np.vstack([_points(300, sd, 3), _iso_tie_points(sd, degree)])
    g, g_total = texp.partition_of_unity_masks(tma.IsoSplit(tT, degree), torch.as_tensor(pts),
                                               unique=unique, raw=True)
    w, w_total = jexp.partition_of_unity_masks(jma.IsoSplit(jT, degree), jnp.asarray(pts),
                                               unique=unique, raw=True)
    assert len(g) == len(w) == degree ** sd
    for a, b in zip(g, w):
        assert np.array_equal(a.numpy(), np.asarray(b))
    if unique:
        assert g_total is None and w_total is None
        assert (sum(g).numpy() == 1.0).all()
    else:
        assert np.array_equal(g_total.numpy(), np.asarray(w_total))
        assert g_total.numpy()[-len(_iso_tie_points(sd, degree)):].max() >= 2


# -- pullback --------------------------------------------------------------------------

@pytest.mark.parametrize("sd", [2, 3])
@pytest.mark.parametrize("mapping", sorted(tma._FORM_DEGREES))
def test_pullback_matches_fiat_tpu(mapping, sd):
    """Each named map on a seeded J, with a leading batch axis and a
    trailing one, given J, J^-1 or both with det J."""
    assert tma._FORM_DEGREES == jma._FORM_DEGREES
    rng = np.random.default_rng(sd)
    J = rng.random((sd, sd)) + np.eye(sd)
    nval = len(tma._FORM_DEGREES[mapping])
    phi = rng.random((5,) + (sd,) * nval + (7,)) - 0.5
    for kw in ({"J": J}, {"Jinv": np.linalg.inv(J)},
               {"J": J, "Jinv": np.linalg.inv(J), "Jdet": np.linalg.det(J)}):
        want = jma.pullback(phi, mapping, **kw)
        got = tma.pullback(phi, mapping, **kw)
        assert got.shape == want.shape == phi.shape
        assert np.abs(got - want).max() <= 1e-15


def test_pullback_refuses_an_unknown_mapping_in_both():
    for mod in (jma, tma):
        with pytest.raises(ValueError, match="Unrecognized mapping"):
            mod.pullback(np.ones((1, 2)), "piola", J=np.eye(2))


# -- the split-variant elements ----------------------------------------------------------

def _element_cases():
    cases = []
    for sd in (2, 3):
        for fam in FAMILIES:
            if fam == "BrezziDouglasFortinMarini" and sd == 3:
                continue
            base = 2 if fam == "BrezziDouglasFortinMarini" else 1
            for split in SPLITS[sd]:
                degrees = range(base, 4) if split in ("alfeld", "iso(2)") else (base,)
                for deg in degrees:
                    if fam == "CrouzeixRaviart" and (deg % 2 == 0 or (sd == 3 and deg > 1)):
                        continue
                    cases.append((fam, sd, deg, split))
    for sd in (2, 3):
        for split in SPLITS[sd]:
            cases += [("CrouzeixRaviart", sd, 1, f"point,{split}"),
                      ("RaviartThomas", sd, 1, f"integral(1),{split}")]
    return cases


ELEMENTS = _element_cases()


@pytest.mark.parametrize("family,sd,degree,variant", ELEMENTS,
                         ids=[f"{f}-{sd}-{d}-{v}" for f, sd, d, v in ELEMENTS])
def test_split_variant_element_matches_fiat_tpu(family, sd, degree, variant):
    """Coefficients, entity dofs and permutations, every dual node's terms
    bit for bit, host tables to 1e-14 (``_same_element``)."""
    jT, tT = _cells(sd)
    try:
        j = getattr(jfe, family)(jT, degree, variant=variant)
    except ValueError as err:
        # a moment family binds its own name as Iso(k)'s lattice family
        assert variant.endswith("iso(2)") and "node family" in str(err)
        with pytest.raises(ValueError, match=str(err).replace("(", r"\(").replace(")", r"\)")):
            getattr(ft, family)(tT, degree, variant=variant)
        return
    t = getattr(ft, family)(tT, degree, variant=variant)
    assert t.is_macroelement() and j.is_macroelement()
    _same_element(j, t)


SWEEP_SPLITS = [s for s in SPECS if s[2].get("variant") in ("iso", "alfeld")]


@pytest.mark.parametrize("spec", SWEEP_SPLITS, ids=map(_label, SWEEP_SPLITS))
def test_sweep_split_entries_match_fiat_tpu(spec):
    """The nodality sweep's split entries (Lagrange iso / alfeld, DG
    alfeld)."""
    _same_element(_build_fiat(spec), _build_port(spec))


@pytest.mark.parametrize("family", ["Lagrange", "DiscontinuousLagrange"])
@pytest.mark.parametrize("sd,degree,variant", [(2, 1, "iso"), (2, 2, "iso(2)"),
                                               (2, 3, "iso(3)"), (3, 1, "iso"),
                                               (3, 2, "iso(2)"), (2, 2, "equispaced,iso(2)"),
                                               (2, 2, "iso(2),gl")])
def test_lagrange_and_dg_iso_variants_match_fiat_tpu(family, sd, degree, variant):
    """Iso(k) with the point family bound after the parse, in either
    order; a family with dofs on subcell boundaries refuses DG in both."""
    jT, tT = _cells(sd)
    try:
        j = getattr(jfe, family)(jT, degree, variant=variant)
    except ValueError as err:
        with pytest.raises(ValueError, match=str(err)[:20]):
            getattr(ft, family)(tT, degree, variant=variant)
        return
    _same_element(j, getattr(ft, family)(tT, degree, variant=variant))


@pytest.mark.parametrize("variant", ["iso", "Iso(2)", "equispaced,iso(3)", "iso(2),gll",
                                     "alfeld", "gl,Powell-Sabin(12)"])
@pytest.mark.parametrize("discontinuous", [False, True])
def test_parse_lagrange_variant_matches_fiat_tpu(variant, discontinuous):
    """The split constructor and the family; an Iso(k) constructor builds
    the same complex as fiat_tpu's on the triangle."""
    try:
        j_split, j_family = jva.parse_lagrange_variant(variant, discontinuous=discontinuous)
    except ValueError:
        with pytest.raises(ValueError):
            tva.parse_lagrange_variant(variant, discontinuous=discontinuous)
        return
    t_split, t_family = tva.parse_lagrange_variant(variant, discontinuous=discontinuous)
    assert t_family == j_family
    assert t_split.__name__ == j_split.__name__
    jT, tT = _cells(2)
    _same_complex(j_split(jT), t_split(tT))


QUADRATURE = [(sd, scheme, degree) for sd in (2, 3)
              for scheme in ("alfeld", "worsey-farin", "powell-sabin", "iso", "alfeld,default",
                             "iso,default", "default,iso") + (("powell-sabin(12)",) if sd == 2
                                                             else ())
              for degree in (2, 4)]


@pytest.mark.parametrize("sd,scheme,degree", QUADRATURE)
def test_split_quadrature_prefixes_match_fiat_tpu(sd, scheme, degree):
    """parse_quadrature_scheme with a split prefix: the composite rule on
    the split, the same points and weights bit for bit."""
    jT, tT = _cells(sd)
    j = jva.parse_quadrature_scheme(jT, degree, scheme)
    t = tva.parse_quadrature_scheme(tT, degree, scheme)
    assert type(t.ref_el).__name__ == type(j.ref_el).__name__
    assert t.ref_el.is_macrocell() and j.ref_el.is_macrocell()
    assert np.array_equal(t.get_points(), np.asarray(j.get_points()))
    assert np.array_equal(t.get_weights(), np.asarray(j.get_weights()))


def test_split_prefixes_are_matched_as_spelled_in_both():
    """fiat_tpu matches a prefix as spelled ('Alfeld' is read as a scheme
    name): the port does the same."""
    jT, tT = _cells(2)
    with pytest.raises(Exception) as j_err:
        jva.parse_quadrature_scheme(jT, 2, "Alfeld")
    with pytest.raises(type(j_err.value)):
        tva.parse_quadrature_scheme(tT, 2, "Alfeld")


# -- degree-0 macro programs -------------------------------------------------------------

DEGREE_0 = [("DiscontinuousLagrange", 2, "alfeld"), ("Regge", 2, "iso(2)"),
            ("HellanHerrmannJohnson", 3, "alfeld")]
ENGINES = {
    "f64": lambda zoo: device_tabulator(zoo, order=1, device="cpu"),
    "f32": lambda zoo: device_tabulator(zoo, order=1, f64=False, device="cpu"),
    "moments": lambda zoo: tmo.moment_engine(BatchedTabulator(zoo, order=0, device="cpu")),
}


@pytest.mark.parametrize("engine", sorted(ENGINES))
@pytest.mark.parametrize("family,sd,variant", DEGREE_0)
def test_degree_0_macro_programs_refuse_by_name(family, sd, variant, engine):
    """A macro program of embedded degree 0: fiat_tpu's BatchedTabulator
    fails in its collocation solve (LinAlgError); each of the port's
    engines raises NotImplementedError naming it.  The element itself
    builds and tabulates on the host in both."""
    jT, tT = _cells(sd)
    j = getattr(jfe, family)(jT, 0, variant=variant)
    t = getattr(ft, family)(tT, 0, variant=variant)
    _same_element(j, t)
    with pytest.raises(np.linalg.LinAlgError):
        JBatchedTabulator([jfe.Lagrange(jT, 1), j], order=1)
    with pytest.raises(NotImplementedError, match="MacroSideProgram: a macro program of "
                                                  "embedded degree 0"):
        ENGINES[engine]([ft.Lagrange(tT, 1), t])


# -- the split zoos ----------------------------------------------------------------------

def _rotated(sd):
    """One element of each family, the families dealt round the splits in
    turn, so that every family and every split is in the zoo (the whole
    product runs in chip_smoke.py against host), then an unsplit Lagrange 2
    and the iso variants of Lagrange 1 and DG 1."""
    fams = [f for f in FAMILIES if sd == 2 or f != "BrezziDouglasFortinMarini"]
    splits = SPLITS[sd]
    specs = [(f, 2 if f == "BrezziDouglasFortinMarini" else 1, splits[i % len(splits)])
             for i, f in enumerate(fams)]
    return specs + [("Lagrange", 2, None), ("Lagrange", 1, "iso"),
                    ("DiscontinuousLagrange", 1, "iso")]


def _build(mod, cells, sd, specs):
    T = cells.ufc_simplex(sd)
    return [getattr(mod, f)(T, d, **({} if v is None else {"variant": v})) for f, d, v in specs]


@pytest.fixture(scope="module")
def zoos():
    return {sd: (_build(jfe, jcl, sd, _rotated(sd)), _build(ft, tcl, sd, _rotated(sd)))
            for sd in (2, 3)}


def _zoo_points(sd, seed):
    return np.vstack([_points(200, sd, seed), _tie_points(sd), _iso_tie_points(sd)])


@pytest.mark.parametrize("sd", [2, 3])
def test_split_zoo_shapes(zoos, sd):
    """One macro program an element, every split among them; the f64
    engine takes K7 past 32 subcells in all, K45 and K3 bin program by
    program."""
    _, tzoo = zoos[sd]
    tab = device_tabulator(tzoo, order=1, device="cpu")
    programs = len(tzoo) - 1
    pieces = {2: 3 + 6 + 6 + 12 + 4 + 3 + 6 + 6 + 12 + 4 + 4 + 4,
              3: 4 + 12 + 24 + 8 + 4 + 12 + 24 + 8 + 4 + 8 + 8}[sd]
    mo = merged_macro(tab)
    assert (len(mo.geom), len(mo.nexp), mo.name) == (programs, pieces, "K7")
    eng = tmo.moment_engine(BatchedTabulator(tzoo, order=0, device="cpu"))
    assert (eng.moments.nprogs, len(eng.moments.piece_nexp)) == (programs, pieces)
    assert len(merged_macro(eng).geom) == programs


@pytest.mark.parametrize("sd", [2, 3])
def test_split_zoo_f64_engine_matches_fiat_tpu_interpret_and_host(zoos, sd):
    """device_tabulator(zoo, order=1) against fiat_tpu's interpreted
    FusedZooTabulator (1e-11 of max(1, max |table|)) and host (1e-10), on
    random points and on
    points where subcells meet, the Iso splits' internal facets among
    them."""
    jzoo, tzoo = zoos[sd]
    pts = _zoo_points(sd, 41)
    bt = JBatchedTabulator(jzoo, order=1)
    ref = bt.unpack(JFusedZooTabulator(bt, interpret=True, row_block=256,
                                       point_tile=256)(jnp.asarray(pts)))
    tab = device_tabulator(tzoo, order=1, device="cpu")
    got = tab.unpack(tab.block_tables(pts))
    assert (tab.recurrence.launches, tab.matmul.launches, merged_macro(tab).launches) == (0, 0, 0)
    for r, g, el in zip(ref, got, tzoo):
        host = el.tabulate(1, pts)
        assert set(r) == set(g) == set(host)
        for a in r:
            bar = RTOL_ENGINE * max(1.0, float(np.abs(host[a]).max()))
            assert np.abs(np.asarray(r[a]) - g[a].numpy()).max() <= bar, (type(el).__name__, a)
            assert np.abs(host[a] - g[a].numpy()).max() <= ATOL_HOST, (type(el).__name__, a)


@pytest.mark.parametrize("sd", [2, 3])
def test_split_zoo_moments_and_interpolation_match_fiat_tpu(zoos, sd):
    """moment_rows (K45's plain version) and interpolate_rows (K1's and
    K3's one row a program) against fiat_tpu's CPU path: 1e-12, but the
    DUAL_WIDE elements to their table bar times the sum of the weights."""
    jzoo, tzoo = zoos[sd]
    pts = _zoo_points(sd, 42)
    rng = np.random.default_rng(43)
    wf = rng.random(len(pts))
    bt = JBatchedTabulator(jzoo, order=0)
    want = np.asarray(jmo.moment_rows(bt, jnp.asarray(pts), jnp.asarray(wf)))
    tb = BatchedTabulator(tzoo, order=0, device="cpu")
    got = tmo.moment_rows(tb, pts, wf).numpy()
    assert got.shape == want.shape
    c = rng.random(len(want)) - 0.5
    mbar, ubar = np.full(len(c), ATOL_DUAL), ATOL_DUAL
    for spec, (lo, hi, _) in zip(_rotated(sd), tb.slices):
        if spec in DUAL_WIDE:
            mbar[lo:hi] = ATOL_HOST * np.abs(wf).sum()
            ubar += ATOL_HOST * np.abs(c[lo:hi]).sum()
    assert (np.abs(got - want) <= mbar).all()
    wi = np.asarray(jmo.interpolate_rows(bt, jnp.asarray(pts), jnp.asarray(c)))
    assert np.abs(tmo.interpolate_rows(tb, pts, c).numpy() - wi).max() <= ubar
    eng = tb._moment_engine
    assert eng.moments.launches == eng.recurrence.launches == merged_macro(eng).launches == 0


@pytest.mark.parametrize("sd", [2, 3])
def test_split_zoo_f32_engine_matches_fiat_tpu_pallas_interpret(zoos, sd):
    """The f32 engine (K6, K3 float32) against fiat_tpu's
    PallasZooTabulator in interpret mode: plain rows to 5e-6 of each
    alpha's max, each macro element's rows to 5e-5 of its max abs + 1."""
    jzoo, tzoo = zoos[sd]
    pts = _points(200, sd, 44)
    want = PallasZooTabulator(JBatchedTabulator(jzoo, order=1), tile=256,
                              interpret=True).tables(pts)
    tab = device_tabulator(tzoo, order=1, f64=False, device="cpu")
    got = tab.tables(pts)
    mo = merged_macro(tab)
    assert (tab.kernel.launches, mo.launches) == (0, 0) and mo.name == "K3"
    pr = tab.plain_rows
    for a in want:
        w, g = np.asarray(want[a]), got[a].numpy()
        assert np.abs(g[:pr] - w[:pr]).max() <= RTOL_F32 * np.abs(w[:pr]).max(), a
        for el, (lo, hi, _) in zip(tzoo, tab.slices):
            if lo >= pr:
                bar = MACRO_TOL * (np.abs(w[lo:hi]).max() + 1.0)
                assert np.abs(g[lo:hi] - w[lo:hi]).max() <= bar, (type(el).__name__, a)


def test_chip_smoke_split_zoo_lists():
    """split_variants_tri: the nine families at degree 1 on Alfeld, PS6,
    PS12 and Iso(2), BDFM 2 on three of them, RT 3 and Nedelec 3 on Alfeld
    and Iso(2), the iso Lagranges and DG, and the ten families unsplit;
    split_variants_tet: the nine on Alfeld, four on Worsey-Farin, PS and
    Iso(2), Lagrange and DG iso, the nine unsplit."""
    nine = ("RaviartThomas", "Nedelec", "BrezziDouglasMarini", "CrouzeixRaviart",
            "NedelecSecondKind", "Regge", "HellanHerrmannJohnson",
            "GopalakrishnanLedererSchoberlFirstKind", "GopalakrishnanLedererSchoberlSecondKind")
    tri = [(f, 1, s) for f in nine for s in ("alfeld", "powell-sabin", "powell-sabin(12)",
                                               "iso(2)")]
    tri += [("BrezziDouglasFortinMarini", 2, s) for s in ("alfeld", "powell-sabin", "iso(2)")]
    tri += [("RaviartThomas", 3, "alfeld"), ("RaviartThomas", 3, "iso(2)"),
            ("Nedelec", 3, "alfeld"), ("Nedelec", 3, "iso(2)"), ("Lagrange", 1, "iso"),
            ("Lagrange", 2, "iso(2)"), ("Lagrange", 3, "iso(3)"),
            ("DiscontinuousLagrange", 1, "iso")]
    tri += [(f, 1, None) for f in nine] + [("BrezziDouglasFortinMarini", 2, None)]
    tet = [(f, 1, "alfeld") for f in nine]
    tet += [(f, 1, s) for f in nine if f in ("RaviartThomas", "Nedelec", "CrouzeixRaviart",
                                             "NedelecSecondKind")
            for s in ("worsey-farin", "powell-sabin", "iso(2)")]
    tet += [("Lagrange", 1, "iso"), ("DiscontinuousLagrange", 1, "iso")]
    tet += [(f, 1, None) for f in nine]
    assert list(chip_smoke.SPLIT_TRI) == tri and len(tri) == 57
    assert list(chip_smoke.SPLIT_TET) == tet and len(tet) == 32
    for sd, specs in ((2, tri), (3, tet)):
        zoo = chip_smoke.families_zoo(specs, (), tcl.ufc_simplex(sd))
        assert sum(el.is_macroelement() for el in zoo) == {2: 47, 3: 23}[sd]
        rows = sum(el.space_dimension() * int(np.prod(el.value_shape())) for el in zoo)
        assert rows == {2: 4051, 3: 5261}[sd]
