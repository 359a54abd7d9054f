"""Split complexes, expansion sets on them, subcell binning and the macro
engine (K3's plain version) of the port against fiat_tpu.

Inputs are numpy arrays made from seeds and handed to both packages; the
fiat_tpu Pallas kernels run in interpret mode, as its own tests run them
(tests/test_device_ops.py).  In interpret mode fiat_tpu takes its merged
macro kernel when the zoo's max degree equals the macro degree and its
per-program kernels otherwise; both are held against the port here."""

import copy

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fiat_tpu import elements as jfe
from fiat_tpu.core import cells as jcl
from fiat_tpu.core import expansions as jexp
from fiat_tpu.core import macro as jmacro
from fiat_tpu.ops.pallas_multiword import FusedZooTabulator as JFusedZooTabulator
from fiat_tpu.ops.tabulate import BatchedTabulator as JBatchedTabulator
from fiat_tpu_torch import device_tabulator
from fiat_tpu_torch import elements as tfe
from fiat_tpu_torch.core import cells as tcl
from fiat_tpu_torch.core import expansions as texp
from fiat_tpu_torch.core import macro as tmacro
from fiat_tpu_torch.ops.fused_zoo import FusedZooTabulator
from fiat_tpu_torch.ops.tabulate import BatchedTabulator, rebase_program
from chip_smoke import merged_macro

SPLITS = ["AlfeldSplit", "PowellSabinSplit", "WorseyFarinSplit", "PowellSabin12Split"]
TOL = 1e-14         # host geometry and expansions: the same numpy algorithm


def _splits(name):
    return getattr(tmacro, name)(tcl.ufc_simplex(2)), getattr(jmacro, name)(jcl.ufc_simplex(2))


def _points(n, seed):
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2))
    return pts / (pts.sum(axis=1)[:, None] + 1e-9) * rng.random((n, 1))


def _special_points():
    """Points exactly on the interior edges of the Alfeld and Powell-Sabin
    splits, on the Alfeld barycentre (= the Powell-Sabin centre), on the
    edge midpoints and on the vertices."""
    c = np.array([1.0, 1.0]) / 3.0
    verts = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    mids = np.array([[0.5, 0.5], [0.0, 0.5], [0.5, 0.0]])
    t = np.array([0.125, 0.25, 0.5, 0.75])[:, None]
    spokes = [v + t * (c - v) for v in np.vstack([verts, mids])]
    return np.vstack([c[None], verts, mids, *spokes])


def _max_diff(ref_tabs, got_tabs):
    return max(float(np.abs(np.asarray(r[a]) - np.asarray(g[a])).max())
               for r, g in zip(ref_tabs, got_tabs) for a in r)


@pytest.mark.parametrize("split", SPLITS)
def test_split_topology_matches_fiat_tpu(split):
    got, want = _splits(split)
    assert got.vertices == want.vertices
    assert got.topology == want.topology
    assert got.get_child_to_parent() == want.get_child_to_parent()
    assert got.get_parent_to_children() == want.get_parent_to_children()
    for dim in got.topology:
        assert list(got.get_interior_facets(dim)) == list(want.get_interior_facets(dim))
    assert got.get_cell_connectivity() == want.get_cell_connectivity()
    assert got.is_macrocell() and got.get_parent() == tcl.ufc_simplex(2)


@pytest.mark.parametrize("split", ["AlfeldSplit", "PowellSabinSplit"])
def test_split_geometry_matches_fiat_tpu(split):
    got, want = _splits(split)
    pts = _points(40, 1)
    for f in got.topology[1]:
        for c in got.connectivity[(1, 2)][f]:
            assert np.abs(got.compute_normal(f, cell=c)
                          - want.compute_normal(f, cell=c)).max() <= TOL
        assert np.abs(got.compute_scaled_normal(f) - want.compute_scaled_normal(f)).max() <= TOL
        assert np.abs(got.compute_edge_tangent(f) - want.compute_edge_tangent(f)).max() <= TOL
        assert np.abs(got.get_entity_transform(1, f)(pts[:5, :1])
                      - want.get_entity_transform(1, f)(pts[:5, :1])).max() <= TOL
    for c in got.topology[2]:
        for rescale in (False, True):
            for g, w in zip(got.barycentric_map((2, c), rescale),
                            want.barycentric_map((2, c), rescale)):
                assert np.abs(g - w).max() <= TOL
            assert np.abs(got.distance_to_point_l1(pts, (2, c), rescale)
                          - want.distance_to_point_l1(pts, (2, c), rescale)).max() <= TOL
    assert abs(got.volume() - want.volume()) <= TOL


def test_simplex_geometry_matches_fiat_tpu():
    for dim in (2, 3):
        got, want = tcl.ufc_simplex(dim), jcl.ufc_simplex(dim)
        for f in got.topology[dim - 1]:
            assert np.abs(got.compute_normal(f) - want.compute_normal(f)).max() <= TOL
            assert np.abs(got.compute_scaled_normal(f) - want.compute_scaled_normal(f)).max() <= TOL
        for e in got.topology[1]:
            assert np.abs(got.compute_edge_tangent(e) - want.compute_edge_tangent(e)).max() <= TOL
            for g, w in zip(got.barycentric_map((1, e)), want.barycentric_map((1, e))):
                assert np.abs(g - w).max() <= TOL
        assert got.connectivity == want.connectivity
    assert np.abs(tcl.ufc_simplex(3).compute_face_tangents(1)
                  - jcl.ufc_simplex(3).compute_face_tangents(1)).max() <= TOL


@pytest.mark.parametrize("split", ["AlfeldSplit", "PowellSabinSplit"])
@pytest.mark.parametrize("variant", [None, "bubble"])
def test_expansion_set_on_a_complex_matches(split, variant):
    got_cell, want_cell = _splits(split)
    got, want = texp.ExpansionSet(got_cell, variant=variant), jexp.ExpansionSet(want_cell,
                                                                               variant=variant)
    n = 3
    assert got.get_num_members(n) == want.get_num_members(n)
    assert np.array_equal(got.get_cell_node_map(n), want.get_cell_node_map(n))
    pts = np.vstack([_points(30, 2), _special_points()])
    for order in (0, 1):
        g, w = got._tabulate(n, pts, order), want._tabulate(n, pts, order)
        assert set(g) == set(w)
        assert max(np.abs(g[a] - np.asarray(w[a])).max() for a in w) <= 1e-13
    for c in got_cell.topology[2]:
        assert np.abs(got.get_dmats(n, cell=c) - want.get_dmats(n, cell=c)).max() <= 1e-12
    qp = np.array([[0.2], [0.5], [0.9]])
    for f in got_cell.get_interior_facets(1):
        assert np.abs(got.tabulate_normal_jumps(n, qp, f, order=2)
                      - want.tabulate_normal_jumps(n, qp, f, order=2)).max() <= 1e-12
    vj_g, vj_w = got.tabulate_jumps(n, pts, order=2), want.tabulate_jumps(n, pts, order=2)
    assert all(np.abs(vj_g[r] - vj_w[r]).max(initial=0.0) <= 1e-12 for r in vj_w)


@pytest.mark.parametrize("split,kw", [("AlfeldSplit", dict(order=1, vorder=2, variant="bubble")),
                                      ("PowellSabinSplit", dict(order=1)),
                                      ("PowellSabin12Split", dict(order=1))])
def test_ck_polynomial_set_matches(split, kw):
    degree = 3 if split == "AlfeldSplit" else 2
    got_cell, want_cell = _splits(split)
    got = tmacro.CkPolynomialSet(got_cell, degree, **kw)
    want = jmacro.CkPolynomialSet(want_cell, degree, **kw)
    assert got.get_coeffs().shape == want.get_coeffs().shape
    assert np.abs(got.get_coeffs() - np.asarray(want.get_coeffs())).max() <= 1e-13


@pytest.mark.parametrize("split", ["AlfeldSplit", "PowellSabinSplit"])
@pytest.mark.parametrize("unique", [True, False])
def test_binning_masks_equal_fiat_tpu_exactly(split, unique):
    """On random points and on points exactly on interior edges, on the
    Alfeld barycentre and on the Powell-Sabin centre: the same {0,1} masks
    and the same multiplicity."""
    got_cell, want_cell = _splits(split)
    pts = np.vstack([_points(300, 3), _special_points()])
    g_masks, g_total = texp.partition_of_unity_masks(got_cell, torch.as_tensor(pts),
                                                     unique=unique, raw=True)
    w_masks, w_total = jexp.partition_of_unity_masks(want_cell, jnp.asarray(pts),
                                                     unique=unique, raw=True)
    for g, w in zip(g_masks, w_masks):
        assert np.array_equal(g.numpy(), np.asarray(w))
    if unique:
        assert g_total is None and w_total is None
        assert (sum(g_masks).numpy() == 1.0).all()
    else:
        assert np.array_equal(g_total.numpy(), np.asarray(w_total))
        # the special points sit on 2 (edges) or 3/6 (centre) subcells
        assert g_total.numpy()[-len(_special_points()):].max() >= 3
    g_cpm = texp.compute_cell_point_map(got_cell, pts, unique=unique)
    w_cpm = jexp.compute_cell_point_map(want_cell, pts, unique=unique)
    assert g_cpm.keys() == w_cpm.keys()
    assert all(np.array_equal(g_cpm[c], w_cpm[c]) for c in g_cpm)


def _small_zoo(fe, T):
    return [fe.Lagrange(T, 3), fe.RaviartThomas(T, 2), fe.Nedelec(T, 2),
            fe.BrezziDouglasMarini(T, 2), fe.CubicHermite(T), fe.Morley(T), fe.Argyris(T, 5),
            fe.Bell(T), fe.HsiehCloughTocher(T, 3), fe.QuadraticPowellSabin6(T)]


def _macro_zoo(fe, T):
    return [fe.Lagrange(T, 3), fe.HsiehCloughTocher(T, 3), fe.QuadraticPowellSabin6(T)]


@pytest.mark.parametrize("zoo", [_small_zoo, _macro_zoo])
def test_engine_matches_fiat_tpu_fused_interpret_and_host(zoo):
    """The small zoo (max degree 5 > macro degree 3) runs fiat_tpu's
    per-program macro kernels, Lagrange 3 + HCT + PS6 its merged one."""
    pts = np.vstack([_points(200, 42), _special_points()])
    jzoo, tzoo = zoo(jfe, jcl.ufc_simplex(2)), zoo(tfe, tcl.ufc_simplex(2))
    bt = JBatchedTabulator(jzoo, order=1)
    jfz = JFusedZooTabulator(bt, interpret=True, row_block=256, point_tile=256)
    ref = bt.unpack(jfz(jnp.asarray(pts)))

    tab = device_tabulator(tzoo, order=1, device="cpu")
    blocks = tab.block_tables(pts)
    assert len(blocks[(0, 0)]) == len(tab.widths) + 2     # one block per macro element
    got = tab.unpack(blocks)
    assert tab.recurrence.launches == tab.matmul.launches == merged_macro(tab).launches == 0
    assert _max_diff(ref, got) <= 1e-11
    assert _max_diff([el.tabulate(1, pts) for el in tzoo], got) <= 1e-10


def test_order_zero_unique_binning_matches_host():
    """At order 0 the C0 (bubble) HCT basis bins uniquely, PS6 averages."""
    pts = np.vstack([_points(150, 7), _special_points()])
    tzoo = _macro_zoo(tfe, tcl.ufc_simplex(2))
    tab = device_tabulator(tzoo, order=0, device="cpu")
    assert [g["unique"] for g in merged_macro(tab).geom] == [True, False]
    got = tab.unpack(tab.block_tables(pts))
    assert _max_diff([el.tabulate(0, pts) for el in tzoo], got) <= 1e-12


def test_k3_plain_matches_the_batched_programs():
    """MacroOneShot's plain version (masks, recurrence, masked B, matmul,
    recip) against MacroSideProgram.tables, program by program."""
    pts = torch.as_tensor(np.vstack([_points(120, 5), _special_points()]))
    bt = BatchedTabulator(_small_zoo(tfe, tcl.ufc_simplex(2)), order=1, device="cpu")
    fz = FusedZooTabulator(bt, device="cpu")
    out = merged_macro(fz)(pts)
    assert tuple(out.shape) == (merged_macro(fz).rows, len(pts))
    # HCT 12 + PS6 9 basis rows x 3 alphas; K = 3 subcells x 10 + 6 x 6
    assert (merged_macro(fz).rows, merged_macro(fz).K) == (63, 66)
    for prog, g in zip(bt.macro_programs, merged_macro(fz).geom):
        want = torch.cat(list(prog.tables(pts, 1).values()), dim=0)
        r0, r1 = g["rows"]
        assert (out[r0:r1] - want).abs().max().item() <= 1e-13


def test_from_arrays_on_fiat_tpu_macro_programs():
    pts = _points(150, 9)
    jzoo = _small_zoo(jfe, jcl.ufc_simplex(2))
    bt = JBatchedTabulator(jzoo, order=1, matmul="native")
    fz = FusedZooTabulator.from_arrays(
        stacked=bt.stacked, alpha_mats=bt.alpha_mats, slices=bt.slices,
        plain_nexp=bt.plain_nexp, max_degree=bt.max_degree,
        scale=float(bt.target_es.get_scale(bt.max_degree)),
        affine_map=bt.target_es.affine_mappings[0], macro_programs=bt.macro_programs, device="cpu")
    ref = bt.unpack(bt(jnp.asarray(pts)))
    assert _max_diff(ref, fz.unpack(fz.block_tables(pts))) <= 1e-12
    cat = fz(pts)
    want = bt(jnp.asarray(pts))
    assert max(np.abs(cat[a].numpy() - np.asarray(want[a])).max() for a in want) <= 1e-12


#: edits of a macro program's parent that take it off the zoo's parent
#: basis: a variant, another cell map (the triangle onto the reference
#: simplex with its vertices rotated: another Dubiner basis of the same
#: polynomials, as well conditioned), another scale
PARENT_EDITS = (("variant", "dual"),
                ("affine_mappings", [tcl.make_affine_mapping(
                    np.roll(tcl.ufc_simplex(2).get_vertices(), 1, axis=0),
                    tcl.default_simplex(2).get_vertices())]),
                ("get_scale", lambda n, cell=0: 0.5))


def _edited(prog, attr, value):
    """The program on its parent's basis edited by ``attr`` = ``value``,
    its tall matrix re-expressed on that basis (``rebase_program``), so
    that its tables stay the element's."""
    pes = copy.copy(prog.parent_es)
    setattr(pes, attr, value)
    return rebase_program(prog, pes)


def test_engine_refuses_programs_the_one_shot_engine_cannot_take():
    """Where the programs do not share one parent basis (which the port
    once refused), the engine runs them by route, fiat_tpu's per-program
    fallback (``macro_fms``) in groups: a variant parent on K2 over its
    masked parent, another cell map or scale on a K3 of its own.  Held to
    fiat_tpu's interpreted per-program route on the same edited programs
    at 1e-12 and to host at 1e-10."""
    pts = np.vstack([_points(150, 4), _special_points()])
    tzoo, jzoo = _macro_zoo(tfe, tcl.ufc_simplex(2)), _macro_zoo(jfe, jcl.ufc_simplex(2))
    st = BatchedTabulator(tzoo, order=1, device="cpu").state()
    jbt = JBatchedTabulator(jzoo, order=1, matmul="native")
    jprogs = list(jbt.macro_programs)
    host = [el.tabulate(1, pts) for el in tzoo]
    for (attr, value), routes in zip(PARENT_EDITS, (["K3", "K2"], ["K3", "K3"], ["K3", "K3"])):
        programs = [_edited(st["macro_programs"][0], attr, value), *st["macro_programs"][1:]]
        fz = FusedZooTabulator.from_arrays(**{**st, "macro_programs": programs}, device="cpu")
        assert [r.name for r in fz.macro_routes] == routes
        assert [r.members for r in fz.macro_routes] == [[1], [0]]
        got = fz.unpack(fz.block_tables(pts))
        jbt.macro_programs = [_edited(jprogs[0], attr, value), *jprogs[1:]]
        jfz = JFusedZooTabulator(jbt, interpret=True, row_block=256, point_tile=256)
        jfz.macro_merged = None                # fiat_tpu's per-program route
        jfz._jit_blocks = jax.jit(jfz._f64_blocks)
        want = jfz.unpack({a: [np.asarray(x) for x in v]
                           for a, v in jfz.block_tables(jnp.asarray(pts)).items()})
        assert _max_diff(want, got) <= 1e-12, attr
        assert _max_diff(host, got) <= 1e-10, attr
        assert all(r.engine.launches == 0 for r in fz.macro_routes)


def test_k3_wrapper_checks_its_inputs():
    fz = device_tabulator(_macro_zoo(tfe, tcl.ufc_simplex(2)), order=1, device="cpu")
    with pytest.raises(TypeError):
        merged_macro(fz)(torch.zeros((4, 2), dtype=torch.float32))
    with pytest.raises(ValueError):
        merged_macro(fz)(torch.zeros((4, 3), dtype=torch.float64))
    with pytest.raises(ValueError, match="engine on cpu"):
        merged_macro(fz)(torch.zeros((4, 2), dtype=torch.float64, device="meta"))
    assert merged_macro(fz).launches == 0


@pytest.mark.parametrize("sd,variant,route", [(2, "alfeld", "K3"), (3, "worsey-farin", "K7")])
def test_dg0_beside_a_macro_element_takes_the_per_program_route(sd, variant, route):
    """A zoo of DG 0 beside Lagrange 2 on a split: the zoo's degree-0
    basis has scale 1 (the constant member is exactly 1), the program's
    parent another, so fiat_tpu's merged kernel refuses the program and
    its per-program route (macro_fms) runs it, where the port once raised.
    The port runs it on a K3 of its own (a K7 with its own K1 on the
    tetrahedron): f64 tables and moments against fiat_tpu's interpreted
    route at 1e-12 of max(1, max |table|) and host, f32 at fiat_tpu's
    macro bar."""
    from fiat_tpu.ops import device_tabulator as jdevice_tabulator
    from fiat_tpu.ops import moments as jmo
    from fiat_tpu_torch.ops import moments as tmo

    def zoo(fe, cl):
        K = cl.ufc_simplex(sd)
        return [fe.DiscontinuousLagrange(K, 0), fe.Lagrange(K, 2, variant=variant)]
    rng = np.random.default_rng(31 + sd)
    pts = rng.random((120, sd))
    pts = pts / (pts.sum(axis=1)[:, None] + 1e-9) * rng.random((120, 1))
    tzoo, jzoo = zoo(tfe, tcl), zoo(jfe, jcl)
    jtab = jdevice_tabulator(jzoo, order=1, matmul="native", interpret=True)
    assert jtab.macro_merged is None and len(jtab.macro_fms) == 1
    tab = device_tabulator(tzoo, order=1, device="cpu")
    (r,) = tab.macro_routes
    assert (r.name, r.on_zoo, r.recurrence is not None) == (route, False, route == "K7")
    want = jtab.unpack(jtab.block_tables(jnp.asarray(pts)))
    got = tab.unpack(tab.block_tables(pts))
    for w, g, el in zip(want, got, tzoo):
        host = el.tabulate(1, pts)
        for a in w:
            scale = max(1.0, float(np.abs(host[a]).max()))
            assert np.abs(g[a].numpy() - np.asarray(w[a])).max() <= 1e-12 * scale, a
            assert np.abs(g[a].numpy().reshape(host[a].shape) - host[a]).max() <= 1e-12 * scale
    wf = rng.random(len(pts))
    bt = BatchedTabulator(tzoo, order=0, device="cpu")
    m = tmo.moment_rows(bt, pts, wf).numpy()
    jm = np.asarray(jmo.moment_rows(JBatchedTabulator(jzoo, order=0), jnp.asarray(pts),
                                    jnp.asarray(wf)))
    assert np.abs(m - jm).max() <= 1e-12
    assert len(bt._moment_engine.moment_kernels) == 2
    t32 = device_tabulator(tzoo, order=1, f64=False, device="cpu").tables(pts)
    j32 = jdevice_tabulator(jzoo, order=1, f64=False, matmul="native",
                            interpret=True).tables(jnp.asarray(pts))
    for a in j32:
        w = np.asarray(j32[a])
        assert np.abs(t32[a].numpy() - w).max() <= 5e-5 * (np.abs(w).max() + 1.0)
