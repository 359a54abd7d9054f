"""Split-variant elements (Alfeld, Worsey-Farin, Powell-Sabin) and the K7
macro engine of the port against fiat_tpu, on tetrahedra and triangles.

The zoo is sv_macro_tet, the Scott-Vogelius pairs on barycentrically
refined tetrahedra.  Inputs are numpy arrays made from seeds and handed to
both packages; fiat_tpu's Pallas kernels run in interpret mode, as its own
tests run them (tests/test_device_ops.py), where its macro tables come from
the merged masked kernel (K7) because the one-shot engine is off."""

import math

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fiat_tpu import elements as jfe
from fiat_tpu.core import cells as jcl
from fiat_tpu.core import expansions as jexp
from fiat_tpu.core import macro as jmacro
from fiat_tpu.core.variants import parse_lagrange_variant as jparse_lagrange_variant
from fiat_tpu.ops.pallas_multiword import FusedZooTabulator as JFusedZooTabulator
from fiat_tpu.ops.tabulate import BatchedTabulator as JBatchedTabulator
from fiat_tpu_torch import device_tabulator
from fiat_tpu_torch import elements as tfe
from fiat_tpu_torch.core import cells as tcl
from fiat_tpu_torch.core import expansions as texp
from fiat_tpu_torch.core import macro as tmacro
from fiat_tpu_torch.core.variants import parse_lagrange_variant
from fiat_tpu_torch.ops.fused_zoo import FusedZooTabulator
from fiat_tpu_torch.ops.macro_oneshot import (CHUNK_ROWS, COLUMN_STRIDE, FIRST_IN_CHUNK,
                                              FIRST_IN_PROGRAM, LAST_IN_CHUNK, SAME_BINS,
                                              chunk_table, slice_table)
from fiat_tpu_torch.ops.masked_matmul import MaskedMatmul
from chip_smoke import merged_macro

TOL_COEFFS = 1e-14      # the same numpy construction on both sides
TOL_FIAT = 1e-11        # engine vs fiat_tpu's interpreted engine (its Ozaki windows)
TOL_HOST = 1e-11        # engine vs host el.tabulate (both f64)
TOL_K7 = 1e-12          # K7's plain version vs fiat_tpu's interpreted K7
RTOL_REPLAY = 1e-13     # the kernel's loop vs the plain version: the order of sums differs
TOL_DG6 = 3e-10         # Worsey-Farin DG 6 vs fiat_tpu and host, / max(1, max |table|)


def sv_macro_tet(fe, T):
    """The Scott-Vogelius pairs: P3 / DG2 on Alfeld splits, P2 / DG1 on
    Worsey-Farin splits, beside the unsplit P1 and P3."""
    return [fe.Lagrange(T, 1), fe.Lagrange(T, 3), fe.Lagrange(T, 3, variant="alfeld"),
            fe.DiscontinuousLagrange(T, 2, variant="alfeld"),
            fe.Lagrange(T, 2, variant="worsey-farin"),
            fe.DiscontinuousLagrange(T, 1, variant="worsey-farin")]


ELEMENTS = [("Lagrange", 3, 1, None), ("Lagrange", 3, 3, None), ("Lagrange", 3, 3, "alfeld"),
            ("DiscontinuousLagrange", 3, 2, "alfeld"), ("Lagrange", 3, 2, "worsey-farin"),
            ("DiscontinuousLagrange", 3, 1, "worsey-farin"), ("Lagrange", 2, 3, "alfeld"),
            ("DiscontinuousLagrange", 2, 2, "powell-sabin")]


def _points(n, seed, sd=3):
    """Uniform points in the UFC simplex (bench.py's pts2 / pts3 construction)."""
    rng = np.random.default_rng(seed)
    pts = rng.random((n, sd))
    return pts / (pts.sum(axis=1)[:, None] + 1e-9) * rng.random((n, 1))


def _tet_special_points():
    """Points where subcells meet: the barycentre (the Alfeld and
    Worsey-Farin centre), the face centres (Worsey-Farin), the vertices,
    points on the Alfeld interior faces and on the Worsey-Farin interior
    edges (centre to vertices, to face centres, face centres to vertices)."""
    V = np.array([[0.0, 0.0, 0.0], [1.0, 0.0, 0.0], [0.0, 1.0, 0.0], [0.0, 0.0, 1.0]])
    c = V.mean(axis=0)
    faces = [V[[j for j in range(4) if j != i]].mean(axis=0) for i in range(4)]
    t = np.array([0.25, 0.5, 0.75])[:, None]
    segs = [v + t * (c - v) for v in list(V) + faces]
    segs += [f + t * (V[j] - f) for i, f in enumerate(faces) for j in range(4) if j != i]
    alfeld_faces = [(V[i] + V[j] + c) / 3 for i in range(4) for j in range(i + 1, 4)]
    return np.vstack([c[None], np.asarray(faces), V, *segs, np.asarray(alfeld_faces)])


def _max_diff(ref_tabs, got_tabs):
    return max(float(np.abs(np.asarray(r[a]) - np.asarray(g[a])).max())
               for r, g in zip(ref_tabs, got_tabs) for a in r)


@pytest.mark.parametrize("family,sd,degree,variant", ELEMENTS)
def test_split_variant_elements_match_fiat_tpu(family, sd, degree, variant):
    kw = {} if variant is None else {"variant": variant}
    ref = getattr(jfe, family)(jcl.ufc_simplex(sd), degree, **kw)
    el = getattr(tfe, family)(tcl.ufc_simplex(sd), degree, **kw)
    assert el.space_dimension() == ref.space_dimension()
    assert el.entity_dofs() == ref.entity_dofs()
    assert el.is_macroelement() == ref.is_macroelement() == (variant is not None)
    assert el.get_reference_element() == tcl.ufc_simplex(sd)
    assert np.abs(el.get_coeffs() - np.asarray(ref.get_coeffs())).max() <= TOL_COEFFS
    pts = [tuple(n.points[0]) for n in el.dual_basis()]
    assert np.array_equal(np.asarray(pts), np.asarray([tuple(n.points[0])
                                                       for n in ref.dual_basis()]))


def test_split_dual_sets_merge_onto_the_parent_like_fiat_tpu():
    """Point-evaluation duals on a split collect onto the parent's entities,
    lexicographically sorted; get_indices reads them as fiat_tpu's does."""
    el = tfe.Lagrange(tcl.ufc_simplex(3), 3, variant="alfeld")
    ref = jfe.Lagrange(jcl.ufc_simplex(3), 3, variant="alfeld")
    dual, jdual = el.get_dual_set(), ref.get_dual_set()
    assert dual.get_reference_element().get_parent() is None
    assert dual.get_entity_closure_ids() == jdual.get_entity_closure_ids()
    for domain in ("interior", "vertex", "edge", "face", "facet", "ridge"):
        for closure in (True, False):
            assert dual.get_indices(domain, closure) == jdual.get_indices(domain, closure)
    with pytest.raises(RuntimeError):
        dual.get_indices("nowhere")


def test_variants_return_split_constructors_and_refuse_iso():
    for name, split in (("alfeld", tmacro.AlfeldSplit), ("Worsey-Farin", tmacro.WorseyFarinSplit),
                        ("powell-sabin", tmacro.PowellSabinSplit),
                        ("powell-sabin(12)", tmacro.PowellSabin12Split)):
        assert parse_lagrange_variant(name) == (split, "gll")
        assert parse_lagrange_variant(f"gl,{name}", discontinuous=True) == (split, "gl")
    with pytest.raises(ValueError, match="not unisolvent"):
        parse_lagrange_variant("equispaced,alfeld", discontinuous=True)
    # Iso splits, as fiat_tpu's (a tetrahedron takes degree 2 only)
    for iso, sd in (("iso", 3), ("Iso(2)", 3), ("equispaced,iso(3)", 2)):
        split, family = parse_lagrange_variant(iso)
        j_split, j_family = jparse_lagrange_variant(iso)
        assert family == j_family and split.__name__ == j_split.__name__
        got, want = split(tcl.ufc_simplex(sd)), j_split(jcl.ufc_simplex(sd))
        assert type(got).__name__ == type(want).__name__ == "IsoSplit"
        assert np.array_equal(np.asarray(got.get_vertices()), np.asarray(want.get_vertices()))
        assert got.get_topology() == want.get_topology()
    # degree 0 on a split is one constant per subcell, not P0
    dg0 = tfe.DiscontinuousLagrange(tcl.ufc_simplex(3), 0, variant="alfeld")
    assert type(dg0).__name__ == "DiscontinuousLagrange" and dg0.space_dimension() == 4


@pytest.mark.parametrize("split", ["AlfeldSplit", "WorseyFarinSplit"])
@pytest.mark.parametrize("unique", [True, False])
def test_tet_binning_masks_equal_fiat_tpu_exactly(split, unique):
    """Random points, and points on interior faces, edges and centres: the
    same {0,1} masks and the same cover counts as fiat_tpu's."""
    got_cell = getattr(tmacro, split)(tcl.ufc_simplex(3))
    want_cell = getattr(jmacro, split)(jcl.ufc_simplex(3))
    pts = np.vstack([_points(300, 3), _tet_special_points()])
    g_masks, g_total = texp.partition_of_unity_masks(got_cell, torch.as_tensor(pts),
                                                     unique=unique, raw=True)
    w_masks, w_total = jexp.partition_of_unity_masks(want_cell, jnp.asarray(pts),
                                                     unique=unique, raw=True)
    assert len(g_masks) == len(w_masks) == (4 if split == "AlfeldSplit" else 12)
    for g, w in zip(g_masks, w_masks):
        assert np.array_equal(g.numpy(), np.asarray(w))
    if unique:
        assert g_total is None and w_total is None
        assert (sum(g_masks).numpy() == 1.0).all()
    else:
        assert np.array_equal(g_total.numpy(), np.asarray(w_total))
        assert g_total.numpy()[-len(_tet_special_points()):].max() >= 4


def test_k7_plain_matches_fiat_tpu_interpreted_k7():
    """K7's plain product on seeded A, Phi and {0,1} masks (as
    tests/test_device_ops.py builds them) against fiat_tpu's
    FusedMaskedMultiword.apply_pair_masked in interpret mode."""
    from fiat_tpu.ops.multiword import prepare_B
    from fiat_tpu.ops.pallas_multiword import FusedMaskedMultiword
    rng = np.random.default_rng(7)
    nexp, npts = 10, 300
    pieces = [(0, 10), (1, 10), (2, 6), (3, 6), (4, 6)]
    A = rng.standard_normal((24, sum(n for _, n in pieces)))
    phi = rng.standard_normal((nexp, npts))
    masks = (rng.random((5, npts)) < 0.5).astype(np.float64)

    fm = FusedMaskedMultiword(A, pieces, interpret=True, row_block=256, point_tile=256)
    slices, sB = prepare_B(jnp.asarray(phi), fm.nslices, wdtype=fm.wdtype)
    hi, lo = jax.jit(lambda s, c, m: fm.apply_pair_masked(s, c, m))(slices, sB,
                                                                     jnp.asarray(masks))
    want = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)

    # two programs (2 and 3 subcells of a triangle split) over the same pieces
    cell = tmacro.PowellSabinSplit(tcl.ufc_simplex(2))
    maps = [cell.barycentric_map(entity=(2, c), rescale=True) for c in range(5)]
    geom = [{"maps": maps[:2], "unique": False, "rows": (0, 12)},
            {"maps": maps[2:], "unique": False, "rows": (12, 24)}]
    mm = MaskedMatmul(A, pieces, geom, tcl.ufc_simplex(2).barycentric_map(rescale=True),
                      device="cpu")
    got = mm.A @ mm.masked_basis(list(torch.as_tensor(masks)), torch.as_tensor(phi))
    assert np.abs(got.numpy() - want).max() <= TOL_K7 * np.abs(want).max()


def _bin_as_the_kernel(maps, x, c0, c1, tol=1e-12):
    """binning.cuh's piece bits in numpy, each operation rounded on its own
    in the kernel's order: (npts, c1 - c0) bool."""
    def dist(M):
        s = None
        for row in M:
            b = x[:, 0] * row[0]
            for i in range(1, x.shape[1]):
                b = b + x[:, i] * row[i]
            t = np.abs(b + row[-1]) - (b + row[-1])
            s = t if s is None else s + t
        return 0.5 * s
    best = dist(maps[0]) + tol
    return np.stack([dist(maps[1 + c]) <= best for c in range(c0, c1)], axis=1)


def _replay_k7(mm, pts, phi):
    """csrc/masked_matmul.cu's loop in numpy, on the wrapper's host layout
    (At, the slice table, the plan) and geometry tables: per point tile of
    the plan, its Phi prefix staged; per program, the binning once; the
    ring's buffers filled as the kernel's bulk copies fill them (slice t
    into buffer t % stages once slice t - stages is done), and each lane
    adding its hit pieces' columns of a slice (a run of k) in piece order."""
    maps, progs, pieces = mm.maps.numpy(), mm.progs.numpy(), mm.pieces.numpy()
    At, slices = mm.At.numpy(), mm.slices.numpy()
    tp, cols, stages, _ = mm.plan
    out = np.full((mm.rows, len(pts)), np.nan)
    ring = np.full((stages, cols * COLUMN_STRIDE), np.nan)

    def fetch(t, s):
        _, _, _, k0, k1, off, npieces, _, n, _, _ = slices[t]
        assert n == (k1 - k0) * npieces * COLUMN_STRIDE
        ring[s, :n] = At[off:off + n]

    for p0 in range(0, len(pts), tp):
        x, Bs = pts[p0:p0 + tp], phi[:mm.max_nexp, p0:p0 + tp]
        for s in range(min(stages, len(slices))):
            fetch(s, s)
        for t, (g, row0, nrows, k0, k1, _, npieces, flags, _, _, _) in enumerate(slices):
            _, _, c0, c1, unique = progs[g]
            if flags & FIRST_IN_PROGRAM and not flags & SAME_BINS:
                hits = _bin_as_the_kernel(maps, x, c0, c1)
                if unique:      # the first hit alone
                    hits &= np.cumsum(hits, axis=1) == 1
                recip = 1.0 if unique else 1.0 / hits.sum(axis=1)
            if flags & FIRST_IN_CHUNK:
                acc = np.zeros((nrows, len(x)))
            buf = ring[t % stages].reshape(cols, COLUMN_STRIDE)
            for j in range(npieces):
                for k in range(k0, min(pieces[c0 + j, 1], k1)):
                    acc += hits[:, j] * buf[(k - k0) * npieces + j, :nrows, None] * Bs[k]
            if t + stages < len(slices):
                fetch(t + stages, t % stages)
            if flags & LAST_IN_CHUNK:
                out[row0:row0 + nrows, p0:p0 + tp] = acc * recip
    return out


@pytest.mark.parametrize("order", [0, 1])
def test_k7_kernel_loop_on_its_chunk_layout_matches_plain(order):
    """The kernel cannot run here: its loop, replayed on the packed slices
    under the wrapper's plan and under a plan whose narrow slices cut the
    chunks into runs of one to three k (and a ragged last point tile), equals the plain
    version, on random and tie points, unique (order 0, C0 bases) and
    averaged."""
    tab = device_tabulator(sv_macro_tet(tfe, tcl.ufc_simplex(3)), order=order, device="cpu")
    mm = merged_macro(tab)
    assert mm.name == "K7" and mm.chunks.shape[0] == sum(
        -(-(g["rows"][1] - g["rows"][0]) // 32) for g in mm.geom)
    assert mm.plan == MaskedMatmul.plan_for(20, 120, 3)
    # at order 1 the Alfeld pair and the Worsey-Farin pair each bin once
    flags = mm.slices.numpy()[:, 7]
    firsts = flags[flags & FIRST_IN_PROGRAM > 0]
    assert list(firsts & SAME_BINS > 0) == [False, order == 1, False, order == 1]
    pts = np.vstack([_points(200, 11), _tet_special_points()])
    phi = tab.recurrence(torch.as_tensor(pts))
    want = mm(torch.as_tensor(pts), phi).numpy()
    for plan in (mm.plan, (64, 13, 3, 1), (256, 120, 2, 2)):  # one k of 12 pieces; whole chunks
        mm.plan = plan
        assert len(pts) % plan[0]
        got = _replay_k7(mm, pts, phi.numpy())
        assert np.abs(got - want).max() <= RTOL_REPLAY * np.abs(want).max()


def _synthetic_tables(nexp, nsub, rows, seed):
    """Geometry-free K7 tables: two programs of ``nsub`` subcells each, of
    ``rows`` and ``rows // 3 + 1`` rows, every piece ``nexp`` wide (the
    first program's last piece one narrower, where it can be), and a random
    A over them: (A, progs, pieces) as ``pack_geometry`` lays them out."""
    widths = [nexp] * (2 * nsub)
    widths[nsub - 1] = max(1, nexp - 1)
    offsets = np.concatenate([[0], np.cumsum(widths)])
    r1 = rows + rows // 3 + 1
    progs = np.array([(0, rows, 0, nsub, 0), (rows, r1, nsub, 2 * nsub, 1)], np.int32)
    pieces = np.column_stack([offsets[:-1], widths]).astype(np.int32)
    A = np.random.default_rng(seed).standard_normal((r1, offsets[-1]))
    return A, progs, pieces


@pytest.mark.parametrize("nsub", [4, 12, 32])
@pytest.mark.parametrize("degree", range(11))
def test_k7_slices_hold_every_entry_of_a_exactly_once(degree, nsub):
    """Every (row, piece, k) of A (a program's rows by its own pieces'
    columns) lies in exactly one slice of the ring,
    under the plan the wrapper would choose and under slices of one k of
    every piece and a few, at the piece widths of tet degrees 0-10 and 4, 12 and 32
    subcells; the slice's block of At holds A's value there, and every other
    staged value is zero.  The flags mark each chunk's first and last slice
    and each program's first."""
    nexp = (degree + 1) * (degree + 2) * (degree + 3) // 6
    A, progs, pieces = _synthetic_tables(nexp, nsub, 45, degree * 100 + nsub)
    chunks = chunk_table(progs, pieces)
    chunk_cols = max(int(progs[g, 3] - progs[g, 2]) * int(kw) for g, _, _, kw in chunks)
    plan = MaskedMatmul.plan_for(nexp, chunk_cols, 3, widest=nsub)
    assert plan is not None
    for cols in sorted({plan[1], nsub, nsub + 7, chunk_cols}):
        slices, gather = slice_table(chunks, progs, pieces, A.shape[1], cols, CHUNK_ROWS, 8)
        At = np.append(A.ravel(), 0.0)[np.where(gather < 0, A.size, gather)]
        seen = np.zeros(A.shape, int)
        staged = np.zeros(At.shape, int)
        for g, row0, nrows, k0, k1, off, npieces, flags, size, c0, unique in slices:
            assert 0 < (k1 - k0) * npieces <= cols and off % 2 == 0
            assert size == (k1 - k0) * npieces * COLUMN_STRIDE
            assert (c0, c0 + npieces, unique) == tuple(progs[g, 2:])
            _, _, c0, c1, _ = progs[g]
            assert npieces == c1 - c0
            for k in range(k0, k1):
                for j in range(npieces):
                    base = off + ((k - k0) * npieces + j) * COLUMN_STRIDE
                    staged[base:base + COLUMN_STRIDE] += 1
                    if k < pieces[c0 + j, 1]:
                        c = pieces[c0 + j, 0] + k
                        seen[row0:row0 + nrows, c] += 1
                        assert np.array_equal(At[base:base + nrows], A[row0:row0 + nrows, c])
                        assert not At[base + nrows:base + COLUMN_STRIDE].any()
                    else:
                        assert not At[base:base + COLUMN_STRIDE].any()
        own = np.zeros(A.shape, int)        # each program's rows by its own pieces' columns
        for r0, r1, c0, c1, _ in progs:
            own[r0:r1, pieces[c0, 0]:pieces[c1 - 1].sum()] = 1
        assert np.array_equal(seen, own) and (staged == 1).all()
        assert ((slices[:, 7] & FIRST_IN_PROGRAM) > 0).sum() == len(progs)
        assert ((slices[:, 7] & FIRST_IN_CHUNK) > 0).sum() == len(chunks)
        assert ((slices[:, 7] & LAST_IN_CHUNK) > 0).sum() == len(chunks)


@pytest.mark.parametrize("sd,degrees", [(2, range(16)), (3, range(11))])
def test_k7_plans_fit_the_shared_memory_at_every_degree(sd, degrees):
    """At every degree K1 tabulates, for chunks from one column to
    sv_macro_tet's widest and a 12-subcell program of 32 rows at that
    degree, the plan exists, holds its blocks in an SM's shared memory
    within a block's limit, and every candidate keeps at least MIN_STAGES
    slices in the ring."""
    M = MaskedMatmul
    for n in degrees:
        kmax = math.comb(n + sd, sd)
        for chunk_cols in (1, 120, 12 * kmax):
            plan = M.plan_for(kmax, chunk_cols, sd)
            assert plan is not None and plan in M.candidates(kmax, chunk_cols, sd)
            for tp, cols, stages, blocks in M.candidates(kmax, chunk_cols, sd, 4):
                smem = M.smem_bytes(kmax, tp, cols, stages)
                assert smem <= M.SMEM_MAX and blocks * (smem + M.SMEM_BLOCK) <= M.SMEM_SM
                assert M.MIN_STAGES <= stages <= M.STAGES
                assert min(chunk_cols, M.MIN_COLS) <= cols <= chunk_cols


def _dg6_case():
    """Lagrange 1 + Worsey-Farin DG 6 in both packages, at 150 random and
    the tie points: (port's CPU tabulator, port zoo, fiat_tpu zoo, points)."""
    T, J = tcl.ufc_simplex(3), jcl.ufc_simplex(3)
    tzoo = [tfe.Lagrange(T, 1), tfe.DiscontinuousLagrange(T, 6, variant="worsey-farin")]
    jzoo = [jfe.Lagrange(J, 1), jfe.DiscontinuousLagrange(J, 6, variant="worsey-farin")]
    pts = np.vstack([_points(150, 21), _tet_special_points()])
    return device_tabulator(tzoo, order=1, device="cpu"), tzoo, jzoo, pts


def _dg6_readings(tab, tzoo, jzoo, pts):
    """The tables of the port, of fiat_tpu's BatchedTabulator and of host
    tabulation, compared pairwise: per pair, the largest difference per
    alpha relative to max(1, its largest value)."""
    port = [{a: t.numpy() for a, t in g.items()} for g in tab.unpack(tab.block_tables(pts))]
    bt = JBatchedTabulator(jzoo, order=1)
    fiat = [{a: np.asarray(t) for a, t in g.items()} for g in bt.unpack(bt(jnp.asarray(pts)))]
    host = [el.tabulate(1, pts) for el in tzoo]
    out = {}
    for name, ref, other in (("port vs fiat_tpu", fiat, port), ("port vs host", host, port),
                             ("fiat_tpu vs host", host, fiat)):
        out[name] = max(np.abs(r[a] - g[a]).max() / max(1.0, float(np.abs(r[a]).max()))
                        for r, g in zip(ref, other) for a in r)
    return out


def test_k7_past_the_old_shared_memory_ceiling_matches_fiat_tpu_and_host():
    """Lagrange 1 + Worsey-Farin DG 6: a row chunk of 274,176 bytes, past a
    block's 227 KB of shared memory (K7 refused the zoo when a whole chunk
    had to fit), streamed through the ring in slices of fewer k.  The
    tables against fiat_tpu's BatchedTabulator and host tabulation, per
    alpha relative to max(1, its largest value), at TOL_DG6: degree 6's
    change of basis (entries up to 5.2e5) leaves fiat_tpu's own engine
    1.46e-10 of that from host here (3.2e-10 on the values, max 2.2; 2.2e-9
    in absolute terms on the derivatives, max 244), and the port 1.56e-10
    from fiat_tpu and 1.46e-10 from host (``PYTHONPATH=. python
    tests/test_torch_macro_tet.py`` prints the three); and the kernel's
    loop on those slices against the plain version."""
    tab, tzoo, jzoo, pts = _dg6_case()
    mm = merged_macro(tab)
    assert mm.name == "K7" and (len(mm.nexp), mm.max_nexp) == (12, 84)
    assert mm.chunk_cols * COLUMN_STRIDE * 8 == 274176 > MaskedMatmul.SMEM_MAX
    assert mm.plan[1] < mm.chunk_cols
    readings = _dg6_readings(tab, tzoo, jzoo, pts)
    assert readings["port vs fiat_tpu"] <= TOL_DG6 and readings["port vs host"] <= TOL_DG6
    # the kernel's loop: its sums cancel (A's entries reach 5.2e5 here), so the
    # order of the sums is held to the scale of |A| |B|, not of the result
    P = torch.as_tensor(np.ascontiguousarray(pts[::4]))
    phi = tab.recurrence(P)
    want = mm(P, phi).numpy()
    scale = (mm.A.abs() @ mm.masked_basis(mm.masks(P)[0], phi).abs()).max().item()
    assert np.abs(_replay_k7(mm, P.numpy(), phi.numpy()) - want).max() <= RTOL_REPLAY * scale


def _engine_checks(tab, tzoo, pts, ref):
    """``ref``: fiat_tpu's tables at the first ``len(ref[0][alpha])`` points."""
    got = tab.unpack(tab.block_tables(pts))
    assert (tab.recurrence.launches, tab.matmul.launches, merged_macro(tab).launches) == (0, 0, 0)
    n = next(iter(ref[0].values())).shape[-1]
    assert _max_diff(ref, [{a: t[..., :n] for a, t in g.items()} for g in got]) <= TOL_FIAT
    assert _max_diff([el.tabulate(1, pts) for el in tzoo], got) <= TOL_HOST


def test_sv_macro_tet_engine_matches_fiat_tpu_k7_path_and_host():
    """The whole zoo through device_tabulator on the CPU (K1, K2, K7 plain)
    and through from_arrays on fiat_tpu's arrays, against fiat_tpu's
    interpreted engine (its merged masked kernel) on random points and
    host tabulation on those and the tie points.  fiat_tpu's windowed K7
    is itself 9.2e-12 from host on these random points and 1.3e-11 with
    the tie points (the port: 1.8e-13), so the tie points are held to host
    alone here, and to fiat_tpu's masks exactly above."""
    T, J = tcl.ufc_simplex(3), jcl.ufc_simplex(3)
    rand = _points(200, 42)
    pts = np.vstack([rand, _tet_special_points()])
    jzoo, tzoo = sv_macro_tet(jfe, J), sv_macro_tet(tfe, T)
    bt = JBatchedTabulator(jzoo, order=1)
    jfz = JFusedZooTabulator(bt, interpret=True, row_block=256, point_tile=256)
    assert jfz.macro_merged is not None and jfz.macro_oneshot is None
    ref = jfz.unpack(jfz.block_tables(jnp.asarray(rand)))

    tab = device_tabulator(tzoo, order=1, device="cpu")
    assert merged_macro(tab).name == "K7" and tab.recurrence.degree == 3
    mo = merged_macro(tab)
    assert (mo.rows, mo.K, len(mo.nexp)) == (632, 288, 32)
    _engine_checks(tab, tzoo, pts, ref)

    fz = FusedZooTabulator.from_arrays(
        stacked=bt.stacked, alpha_mats=bt.alpha_mats, slices=bt.slices,
        plain_nexp=bt.plain_nexp, max_degree=bt.max_degree,
        scale=float(bt.target_es.get_scale(bt.max_degree)),
        affine_map=bt.target_es.affine_mappings[0], macro_programs=bt.macro_programs,
        device="cpu")
    assert merged_macro(fz).name == "K7"
    _engine_checks(fz, tzoo, pts, ref)


def test_macro_degree_above_the_plain_degree_runs_k1_at_the_macro_degree():
    """Lagrange 1 + Alfeld Lagrange 3: K2 reads K1's degree-1 prefix, K7 its
    degree-3 prefix."""
    T = tcl.ufc_simplex(3)
    zoo = [tfe.Lagrange(T, 1), tfe.Lagrange(T, 3, variant="alfeld")]
    tab = device_tabulator(zoo, order=1, device="cpu")
    assert tab.widths == [4] and tab.recurrence.degree == 3 and tab.recurrence.nexp == 20
    pts = np.vstack([_points(200, 5), _tet_special_points()])
    got = tab.unpack(tab.block_tables(pts))
    assert _max_diff([el.tabulate(1, pts) for el in zoo], got) <= TOL_HOST


def test_macro_engine_is_chosen_by_precondition():
    """K3 where it applies (triangles, at most 32 subcells); K7 on
    tetrahedra and on triangle zoos past 32 subcells, where K1 runs at
    the zoo's degree and K7 reads its prefix."""
    T = tcl.ufc_simplex(2)
    small = [tfe.Lagrange(T, 3), tfe.HsiehCloughTocher(T, 3), tfe.QuadraticPowellSabin6(T)]
    assert merged_macro(device_tabulator(small, order=1, device="cpu")).name == "K3"
    wide = small + [tfe.QuadraticPowellSabin12(T), tfe.Lagrange(T, 3, variant="powell-sabin(12)")]
    tab = device_tabulator(wide, order=1, device="cpu")
    assert merged_macro(tab).name == "K7" and len(merged_macro(tab).nexp) == 3 + 6 + 12 + 12
    pts = np.vstack([_points(150, 9, sd=2), [[1 / 3, 1 / 3], [0.25, 0.25], [0.5, 0.0]]])
    got = tab.unpack(tab.block_tables(pts))
    assert _max_diff([el.tabulate(1, pts) for el in wide], got) <= TOL_HOST
    assert merged_macro(device_tabulator(sv_macro_tet(tfe, tcl.ufc_simplex(3)), order=0,
                                         device="cpu")).name == "K7"


def test_k7_wrapper_checks_its_inputs():
    tab = device_tabulator(sv_macro_tet(tfe, tcl.ufc_simplex(3)), order=1, device="cpu")
    mm = merged_macro(tab)
    P = torch.as_tensor(_points(10, 1))
    phi = tab.recurrence(P)
    with pytest.raises(TypeError):
        mm(P.float(), phi)
    with pytest.raises(ValueError, match="points must have shape"):
        mm(P[:, :2].contiguous(), phi)
    with pytest.raises(ValueError, match="phi must have shape"):
        mm(P, phi[:10])
    with pytest.raises(ValueError, match="engine on cpu"):
        mm(P.to("meta"), phi.to("meta"))
    assert mm.launches == 0


def test_tet_macro_zoos_refused_by_the_f32_and_moments_engines():
    """The f32 tables and the interpolation of a tet macro zoo run on K3's
    sd = 3 stage (no longer refused), against the f64 tables and host; its
    moments run on K45 alone and never build K3."""
    from fiat_tpu_torch.ops.moments import MomentEngine
    from fiat_tpu_torch.ops.tabulate import BatchedTabulator
    zoo = sv_macro_tet(tfe, tcl.ufc_simplex(3))
    pts = np.vstack([_points(60, 2), _tet_special_points()])
    f32 = device_tabulator(zoo, order=1, f64=False, device="cpu")
    mo = merged_macro(f32)
    assert mo.name == "K3" and mo.sd == 3 and mo.dtype == torch.float32
    got = f32.tables(pts)
    want = device_tabulator(zoo, order=1, device="cpu")(pts)
    for a in want:
        assert (got[a].double() - want[a]).abs().max().item() <= 5e-5 * (
            want[a].abs().max().item() + 1.0), a
    eng = MomentEngine(BatchedTabulator(zoo, order=0, device="cpu"), device="cpu")
    assert tuple(eng.moment_rows(pts, np.ones(len(pts))).shape) == (eng.rows,)
    assert eng.built == {"moments": True, "macro": False}
    c = np.random.default_rng(3).random(eng.rows) - 0.5
    u = eng.interpolate_rows(pts, c).numpy()
    assert eng.built == {"moments": True, "macro": True} and merged_macro(eng).sd == 3
    host = sum(c[lo:hi] @ el.tabulate(0, pts)[(0, 0, 0)].reshape(hi - lo, len(pts))
               for el, (lo, hi, _) in zip(zoo, eng.slices))
    assert np.abs(u - host).max() <= 1e-12


if __name__ == "__main__":
    # the readings behind TOL_DG6
    print({pair: float(v) for pair, v in _dg6_readings(*_dg6_case()).items()})
