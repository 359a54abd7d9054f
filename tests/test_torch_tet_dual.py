"""Tetrahedra through dual evaluation and the f32 engine: moments and
interpolation (``ops/moments.py`` over K45's sd = 3 stage and K1) and the
f32 engine (``ops/f32_zoo.py`` over K6's sd = 3 stage) against fiat_tpu on
the CPU, K45's sd = 3 plain pieces against fiat_tpu's interpreted masked
moment kernel, and a replay of K45's sd = 3 loop on its packed constants.

Inputs are numpy arrays made from seeds and handed to both packages;
fiat_tpu's ``moment_rows`` and ``interpolate_rows`` run their f64 XLA
fallback on the CPU and its Pallas kernels run in interpret mode, as its own
tests run them (tests/test_device_ops.py)."""

import math
import os
import sys
from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fiat_tpu import elements as jfe
from fiat_tpu.core import cells as jcl
from fiat_tpu.core import expansions as jexp
from fiat_tpu.ops import moments as jmo
from fiat_tpu.ops.pallas_recurrence import PallasMaskedPairMoments
from fiat_tpu.ops.pallas_tabulate import PallasZooTabulator
from fiat_tpu.ops.tabulate import BatchedTabulator as JBatchedTabulator
from fiat_tpu_torch import device_tabulator
from fiat_tpu_torch import elements as tfe
from fiat_tpu_torch.core import cells as tcl
from fiat_tpu_torch.core import expansions as texp
from fiat_tpu_torch.ops import moments as tmo
from fiat_tpu_torch.ops.f32_zoo import F32ZooTabulator, ZooF32Kernel
from fiat_tpu_torch.ops.moment_kernel import GROUP, PairMoments, grid_blocks
from fiat_tpu_torch.ops.moments import MomentEngine
from fiat_tpu_torch.ops.tabulate import BatchedTabulator
from chip_smoke import merged_macro

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_macro_tet import _bin_as_the_kernel  # noqa: E402
from test_torch_recurrence import _dubiner1_point, _dubiner2_point  # noqa: E402

ATOL = 1e-12            # against fiat_tpu and host (f64 on both sides)
RTOL_PLAIN = 1e-13      # the same sums in another order of operations
RTOL_INTERPRET = 1e-5   # fiat_tpu's interpreted masked kernel on the CPU (its own bar)
RTOL_F32 = 5e-6         # fiat_tpu's f32 bar (tests/test_device_ops.py:143-144)
ORIGIN = (0, 0, 0)


def _points(n, seed):
    """Uniform points in the UFC tetrahedron (bench.py's pts3 construction)."""
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 3))
    return pts / (pts.sum(axis=1)[:, None] + 1e-9) * rng.random((n, 1))


def _tie_points():
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


def _lagrange(fe, T):
    return [fe.Lagrange(T, p) for p in (1, 2, 3, 4)]


def _hdiv_hcurl(fe, T):
    return ([fe.RaviartThomas(T, k) for k in (1, 2)] + [fe.Nedelec(T, k) for k in (1, 2)]
            + [fe.BrezziDouglasMarini(T, k) for k in (1, 2)])


def _sv(fe, T):
    """The Scott-Vogelius pairs at the lowest degrees: P2 / DG1 on the Alfeld
    and on the Worsey-Farin split, beside P1 (4 programs over 32 subcells)."""
    return [fe.Lagrange(T, 1), fe.Lagrange(T, 2, variant="alfeld"),
            fe.DiscontinuousLagrange(T, 1, variant="alfeld"),
            fe.Lagrange(T, 2, variant="worsey-farin"),
            fe.DiscontinuousLagrange(T, 1, variant="worsey-farin")]


ZOOS = {"lagrange_1_4": _lagrange, "rt_n_bdm_1_2": _hdiv_hcurl}


def _zoos(make):
    return make(jfe, jcl.ufc_simplex(3)), make(tfe, tcl.ufc_simplex(3))


def _host_moments(zoo, slices, pts, wf):
    """Per-element host el.tabulate(0) @ wf, in the fused row order."""
    out = np.zeros(max(hi for _, hi, _ in slices))
    for el, (lo, hi, _) in zip(zoo, slices):
        out[lo:hi] = el.tabulate(0, pts)[ORIGIN].reshape(hi - lo, len(pts)) @ wf
    return out


@pytest.mark.parametrize("zoo", sorted(ZOOS))
def test_moment_rows_match_fiat_tpu_and_host(zoo):
    jzoo, tzoo = _zoos(ZOOS[zoo])
    pts = _points(300, 3)
    wf = np.random.default_rng(4).random(len(pts))
    bt = JBatchedTabulator(jzoo, order=0)
    want = np.asarray(jmo.moment_rows(bt, jnp.asarray(pts), jnp.asarray(wf)))
    tb = BatchedTabulator(tzoo, order=0, device="cpu")
    got = tmo.moment_rows(tb, pts, wf)
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= ATOL
    assert np.abs(got.numpy() - _host_moments(tzoo, tb.slices, pts, wf)).max() <= ATOL
    eng = tb._moment_engine
    assert eng.moments.sd == 3 and eng.moments.launches == 0
    assert eng.built == {"moments": True, "macro": False} and merged_macro(eng) is None


@pytest.mark.parametrize("zoo", sorted(ZOOS))
def test_interpolate_rows_match_fiat_tpu_and_host_without_k45(zoo):
    """Interpolation needs K1 and a matvec only: K45 is never built."""
    jzoo, tzoo = _zoos(ZOOS[zoo])
    pts = _points(300, 5)
    bt = JBatchedTabulator(jzoo, order=0)
    rows = max(hi for _, hi, _ in bt.slices)
    c = np.random.default_rng(6).random(rows) - 0.5
    want = np.asarray(jmo.interpolate_rows(bt, jnp.asarray(pts), jnp.asarray(c)))
    tb = BatchedTabulator(tzoo, order=0, device="cpu")
    got = tmo.interpolate_rows(tb, pts, c)
    assert tuple(got.shape) == (len(pts),)
    assert np.abs(got.numpy() - want).max() <= ATOL
    host = np.zeros(len(pts))
    for el, (lo, hi, _) in zip(tzoo, tb.slices):
        host += c[lo:hi] @ el.tabulate(0, pts)[ORIGIN].reshape(hi - lo, len(pts))
    assert np.abs(got.numpy() - host).max() <= ATOL
    eng = tb._moment_engine
    assert eng.built == {"moments": False, "macro": False}
    assert eng.recurrence.sd == 3 and eng.recurrence.launches == 0


def test_macro_moments_on_32_subcells_match_fiat_tpu_and_host():
    """The SV pairs: 4 programs over 32 subcells (Alfeld 4 + 4, Worsey-Farin
    12 + 12), on random points and on points shared by several subcells."""
    jzoo, tzoo = _zoos(_sv)
    pts = np.vstack([_points(250, 7), _tie_points()])
    wf = np.random.default_rng(8).random(len(pts))
    bt = JBatchedTabulator(jzoo, order=0)
    want = np.asarray(jmo.moment_rows(bt, jnp.asarray(pts), jnp.asarray(wf)))
    tb = BatchedTabulator(tzoo, order=0, device="cpu")
    got = tmo.moment_rows(tb, pts, wf)
    eng = tb._moment_engine
    pm = eng.moments
    assert len(pm.piece_nexp) == 32 and pm.rows == 4 + 4 * 10 + 4 * 4 + 12 * 10 + 12 * 4
    assert [g["unique"] for g in pm.geom] == [True, False, True, False]
    assert not eng.built["macro"]           # moments never need K3
    assert np.abs(got.numpy() - want).max() <= ATOL
    assert np.abs(got.numpy() - _host_moments(tzoo, tb.slices, pts, wf)).max() <= ATOL


def test_interpolation_on_a_tet_macro_zoo_raises_naming_k3():
    """It no longer raises: K1 for the plain rows and K3's sd = 3 stage for
    the folded macro rows, against fiat_tpu and host on random and tie
    points; K45 is built by the moments that follow, never before."""
    jzoo, tzoo = _zoos(_sv)
    pts = np.vstack([_points(200, 9), _tie_points()])
    bt = JBatchedTabulator(jzoo, order=0)
    tb = BatchedTabulator(tzoo, order=0, device="cpu")
    eng = tmo.moment_engine(tb)
    c = np.random.default_rng(10).random(eng.rows) - 0.5
    got = tmo.interpolate_rows(tb, pts, c).numpy()
    assert eng.built == {"moments": False, "macro": True} and merged_macro(eng).sd == 3
    want = np.asarray(jmo.interpolate_rows(bt, jnp.asarray(pts), jnp.asarray(c)))
    assert np.abs(got - want).max() <= ATOL
    host = np.zeros(len(pts))
    for el, (lo, hi, _) in zip(tzoo, tb.slices):
        host += c[lo:hi] @ el.tabulate(0, pts)[ORIGIN].reshape(hi - lo, len(pts))
    assert np.abs(got - host).max() <= ATOL
    assert tuple(tmo.moment_rows(tb, pts, np.ones(len(pts))).shape) == (eng.rows,)


def _k45_case():
    """The SV zoo's K45 (its plain version), fiat_tpu's BatchedTabulator of
    the same zoo, and points: random ones and the tie points."""
    jzoo, tzoo = _zoos(_sv)
    pts = np.vstack([_points(300, 11), _tie_points()])
    wf = np.random.default_rng(12).random(len(pts)) - 0.5
    eng = MomentEngine(BatchedTabulator(tzoo, order=0, device="cpu"), device="cpu")
    return eng.moments, JBatchedTabulator(jzoo, order=0), pts, wf


def test_k45_sd3_pieces_match_fiat_tpu_masked_kernel_and_explicit_masks():
    """K45's plain version on the SV zoo: the masked sums against fiat_tpu's
    PallasMaskedPairMoments (K5) in interpret mode, with entity=(3, c) maps,
    at that kernel's CPU tolerance; every sum against the explicit
    contraction (fiat_tpu's Phi and masked parent stacks) to 1e-13."""
    pm, bt, pts, wf = _k45_case()
    sums = pm(torch.as_tensor(pts), torch.as_tensor(wf)).numpy()
    assert pm.launches == 0 and pm.degree == 2 and pm.nplain == 4

    progs = bt.macro_programs
    rec_deg = max(p.degree for p in progs)
    entries = [{"nexp": p.nexp_parent, "unique": p.es.continuity is not None,
                "maps": [p.es.ref_el.barycentric_map(entity=(3, c), rescale=True)
                         for c in p.cells]} for p in progs]
    parent_map = progs[0].es.ref_el.get_parent().barycentric_map(rescale=True)
    kernel = PallasMaskedPairMoments(progs[0].parent_es, rec_deg, entries, parent_map,
                                     interpret=True, tile=256)
    bws = np.concatenate([np.asarray(b) for b in jax.jit(kernel.moment_rows)(
        jnp.asarray(pts), jnp.asarray(wf))])
    masked = sums[pm.nplain:]
    assert np.abs(masked - bws).max() <= RTOL_INTERPRET * np.abs(bws).max()

    phi = np.asarray(bt._expansion_tables(jnp.asarray(pts))[ORIGIN])
    want = np.concatenate([phi @ wf] + [np.asarray(p.b_stack(jnp.asarray(pts), 0)) @ wf
                                        for p in progs])
    assert np.abs(sums - want).max() <= RTOL_PLAIN * np.abs(want).max()


def _dubiner3_values(x, consts, n, scale):
    """csrc/dubiner3.cuh's recurrence at one point on the packed constants,
    yielding (entry, value) in the order the kernel's emitter sees them."""
    if n == 0:
        yield 0, scale
        return
    c = consts.reshape(-1, 4)
    nexp2 = (n + 1) * (n + 2) // 2
    c1, c2 = c[n + 1:n + 1 + nexp2], c[n + 1 + nexp2:]

    def step(k, fa, fb, fc, prev, prev2):
        return (k[0] * fa - k[1] * fb) * prev - (k[2] * fc) * prev2

    fb = 0.5 * (x[1] + x[2])
    fa, fc = x[0] + fb + 1.0, fb * fb
    prev2, prev, r0 = 0.0, scale, [scale * c[0, 3]]
    for i in range(1, n + 1):
        v = step(c[i], fa, fb, fc, prev, prev2)
        r0.append(v * c[i, 3])
        prev2, prev = prev, v
    fb1 = 0.5 * (x[2] - 1.0)
    fa1, fc1 = x[1] + fb1 + 1.0, fb1 * fb1
    fb2 = 0.5 * (-1.0 + -1.0)
    fa2, fc2 = x[2] + fb2 + 1.0, fb2 * fb2
    e1 = e = 0
    for p in range(n + 1):
        prev2, prev = 0.0, r0[p]
        for q in range(n + 1 - p):
            v = prev
            if q > 0:
                v = step(c1[e1], fa1, fb1, fc1, prev, prev2)
                prev2, prev = prev, v
            s2, s = 0.0, v * c1[e1, 3]
            yield e, s * c2[e, 3]
            e += 1
            for _ in range(1, n + 1 - p - q):
                w = step(c2[e], fa2, fb2, fc2, s, s2)
                yield e, w * c2[e, 3]
                s2, s = s, w
                e += 1
            e1 += 1


def _replay_k45(pm, pts, wf, nblocks, warps=None):
    """csrc/moments.cuh's schedule in numpy on the tables the wrapper built,
    on intervals, triangles or tetrahedra, for a grid of ``nblocks`` blocks of
    ``warps`` warps (the wrapper's ``pm.warps`` unless given; the kernel
    takes 1 to 8).  Warp w of block b takes the 32-point tiles b * warps +
    w, then every nblocks * warps further.  Each point's values of the
    recurrence (dubiner2.cuh, dubiner3.cuh on the packed constants) times
    its weight fill the slab in chunks of 32 entries (0 for the lanes past
    the last point); the lane of entry e (member slots[e]) adds the chunk's
    32 points into its plain sum (four running sums, point k into sum k mod
    4), and for each piece in order the points that hit it: two running
    sums taking the hits in turns, or, where a point of the tile is shared
    by pieces of one program, one sum of 1 / hits times each.  Then the
    warps' sums in warp order into the block's partial, the partials of
    each group of GROUP blocks in block order, and the groups' in group
    order."""
    maps, progs, pieces = pm.maps.numpy(), pm.progs.numpy(), pm.pieces.numpy()
    consts, slots = pm.consts, pm.slots.numpy()
    sd, n, R, warps = pm.sd, len(pts), pm.rows, warps or pm.warps
    ref = (pts @ pm.affine[:sd * sd].reshape(sd, sd).T + pm.affine[sd * sd:]).T
    if sd == 1:
        phi = _dubiner1_point(ref[0], consts, pm.degree, pm.scale)
    elif sd == 2:
        phi = _dubiner2_point(ref[0], ref[1], consts, slots, pm.degree, pm.scale)
    else:
        phi = np.zeros((pm.nexp, n))
        for e, v in _dubiner3_values(ref, consts, pm.degree, pm.scale):
            phi[slots[e]] = v
    values = np.hstack([phi[slots] * wf, np.zeros((pm.nexp, 32))])  # entry order, 0 past n
    hits = np.zeros((n, len(pieces)), bool)
    tie = np.zeros(n, bool)
    recip = np.zeros(hits.shape)
    for _, _, c0, c1, unique in progs:
        h = _bin_as_the_kernel(maps, pts, c0, c1)
        if unique:
            h &= np.cumsum(h, axis=1) == 1
        hits[:, c0:c1] = h
        tie |= h.sum(axis=1) > 1
        recip[:, c0:c1] = 1.0 / np.maximum(h.sum(axis=1), 1)[:, None]
    ntiles = -(-n // 32)
    partials = np.zeros((nblocks, R))
    for b in range(nblocks):
        for w in range(warps):
            plain = np.zeros(pm.nexp)         # by entry
            acc = np.zeros(R - pm.nplain)
            for t in range(b * warps + w, ntiles, nblocks * warps):
                q = np.arange(32 * t, 32 * t + 32)
                live = q[q < n]
                ties = tie[live].any()
                for e0 in range(0, pm.nexp, 32):
                    e = np.arange(e0, min(e0 + 32, pm.nexp))
                    j = slots[e]
                    v = values[e][:, q]
                    s = [np.zeros(len(e)) for _ in range(4)]
                    for k in range(32):
                        s[k % 4] = s[k % 4] + v[:, k]
                    plain[e] += (s[0] + s[1]) + (s[2] + s[3])
                    for c, (off, nk) in enumerate(pieces):
                        ks = live[hits[live, c]] - 32 * t
                        if not len(ks):
                            continue
                        tt = [np.zeros(len(e)), np.zeros(len(e))]
                        for i, k in enumerate(ks):
                            if ties:
                                tt[0] = tt[0] + recip[32 * t + k, c] * v[:, k]
                            else:
                                tt[i % 2] = tt[i % 2] + v[:, k]
                        inside = j < nk
                        acc[off + j[inside]] += (tt[0] + tt[1])[inside]
            sums = np.concatenate([np.zeros(pm.nplain), acc])
            inside = slots < pm.nplain
            sums[slots[inside]] = plain[inside]
            partials[b] = partials[b] + sums
    groups = [_in_order(partials[g:g + GROUP]) for g in range(0, nblocks, GROUP)]
    return _in_order(np.asarray(groups))


def _in_order(rows):
    """The rows summed one after another from zero, as the kernel does."""
    out = np.zeros(rows.shape[1])
    for r in rows:
        out = out + r
    return out


#: grids the replays run: (nblocks, warps) from the points' count; one tile
#: a warp (the card's grid at 2 blocks an SM of 132), one block whose warps
#: loop over the tiles, and 37 one-warp blocks (three groups of partials,
#: the last short)
K45_GRIDS = {"one_tile_a_warp": lambda n, pm: (grid_blocks(n, pm.warps, 2, 132), pm.warps),
             "one_block": lambda n, pm: (1, pm.warps),
             "thirty_seven_blocks": lambda n, pm: (37, 1)}


@pytest.mark.parametrize("grid", sorted(K45_GRIDS))
@pytest.mark.parametrize("where", ["random", "tie"])
def test_k45_sd3_kernel_loop_on_its_packed_tables_matches_plain(where, grid):
    """The kernel cannot run here: its schedule (slab chunks, lane-owned
    members, block and last-block reductions) replayed on the packed
    constants and binning tables equals the plain version, on random points
    and on tie points (the first hit of each C0 program, 1 / hits of each
    DG program: up to 12 pieces of one program at the centre)."""
    pm, _, pts, wf = _k45_case()
    assert [g["unique"] for g in pm.geom] == [True, False, True, False]
    n = len(_tie_points())
    pts, wf = (pts[:-n], wf[:-n]) if where == "random" else (pts[-n:], wf[-n:])
    want = pm(torch.as_tensor(pts), torch.as_tensor(wf)).numpy()
    got = _replay_k45(pm, pts, wf, *K45_GRIDS[grid](len(pts), pm))
    assert np.abs(got - want).max() <= RTOL_PLAIN * np.abs(want).max()


def test_k45_sd3_plain_rows_replay_at_degree_8():
    """tet_lagrange8's K45: 165 plain rows in 6 chunks, no pieces; blocks
    of 4 warps (the tetrahedron from degree 7) of 8 x 1056 bytes each, the
    slab alone (the card's occupancy then sets the blocks an SM from the
    registers)."""
    tb = BatchedTabulator([tfe.Lagrange(tcl.ufc_simplex(3), 8)], order=0, device="cpu")
    pm = tmo.moment_engine(tb).moments
    assert (pm.degree, pm.nplain, pm.rows, pm.warps, pm.smem) == (8, 165, 165, 4, 4 * 8 * 1056)
    pts = _points(40, 13)
    wf = np.random.default_rng(14).random(len(pts))
    want = pm(torch.as_tensor(pts), torch.as_tensor(wf)).numpy()
    for grid in K45_GRIDS.values():
        got = _replay_k45(pm, pts, wf, *grid(len(pts), pm))
        assert np.abs(got - want).max() <= RTOL_PLAIN * np.abs(want).max()


def test_engine_from_fiat_tpu_arrays_matches_the_ports():
    """The carry-over of host state: MomentEngine.from_arrays on fiat_tpu's
    BatchedTabulator arrays equals the port's own engine, on a plain zoo
    (moments and interpolation) and on the SV zoo (moments)."""
    pts = np.vstack([_points(200, 15), _tie_points()])
    rng = np.random.default_rng(16)
    wf = rng.random(len(pts))
    for make in (_hdiv_hcurl, _sv):
        jzoo, tzoo = _zoos(make)
        bt = JBatchedTabulator(jzoo, order=0)
        jeng = MomentEngine.from_arrays(
            stacked=bt.stacked, slices=bt.slices, max_degree=bt.max_degree,
            scale=float(bt.target_es.get_scale(bt.max_degree)),
            affine_map=bt.target_es.affine_mappings[0], macro_programs=bt.macro_programs,
            device="cpu")
        teng = MomentEngine(BatchedTabulator(tzoo, order=0, device="cpu"), device="cpu")
        assert np.abs(jeng.moment_rows(pts, wf).numpy()
                      - teng.moment_rows(pts, wf).numpy()).max() <= RTOL_PLAIN
        if make is _hdiv_hcurl:
            c = rng.random(teng.rows) - 0.5
            assert np.abs(jeng.interpolate_rows(pts, c).numpy()
                          - teng.interpolate_rows(pts, c).numpy()).max() <= RTOL_PLAIN


def _sv_lagrange10(fe, T):
    """The SV pairs beside Lagrange 10: K45 at degree 10, 286 plain rows
    and 224 masked ones over 32 subcells (510, past the 454 the per-lane
    layout took)."""
    return [fe.Lagrange(T, 10)] + _sv(fe, T)[1:]


def test_moment_rows_past_the_old_row_cap_match_fiat_tpu_and_host():
    jzoo, tzoo = _zoos(_sv_lagrange10)
    pts = np.vstack([_points(150, 23), _tie_points()])
    wf = np.random.default_rng(24).random(len(pts))
    bt = JBatchedTabulator(jzoo, order=0)
    want = np.asarray(jmo.moment_rows(bt, jnp.asarray(pts), jnp.asarray(wf)))
    tb = BatchedTabulator(tzoo, order=0, device="cpu")
    got = tmo.moment_rows(tb, pts, wf)
    pm = tb._moment_engine.moments
    assert (pm.degree, pm.nplain, pm.rows, len(pm.piece_nexp)) == (10, 286, 510, 32)
    assert np.abs(got.numpy() - want).max() <= ATOL
    assert np.abs(got.numpy() - _host_moments(tzoo, tb.slices, pts, wf)).max() <= ATOL


def test_k45_sd3_wrapper_checks_and_limits():
    pm, _, pts, wf = _k45_case()
    with pytest.raises(ValueError, match=r"points must have shape \(npts, 3\)"):
        pm(torch.as_tensor(pts[:, :2]).contiguous(), torch.as_tensor(wf))
    with pytest.raises(ValueError, match="engine on cpu"):
        pm(torch.as_tensor(pts, device="meta"), torch.as_tensor(wf, device="meta"))
    es = texp.ExpansionSet(tcl.ufc_simplex(3))
    amap = es.affine_mappings[0]
    # degree 11, past the unrolled 10, runs the generic instantiation: its
    # plain sums are the degree-11 basis times the weights
    gen = PairMoments(11, 364, float(es.get_scale(11)), amap, device="cpu")
    P, W = torch.as_tensor(pts), torch.as_tensor(wf)
    want = texp.dubiner_tabulate(3, 11, [(P @ torch.as_tensor(amap[0]).T
                                          + torch.as_tensor(amap[1]))[:, i] for i in range(3)],
                                 float(es.get_scale(11))) @ W
    assert gen.generic and torch.allclose(gen(P, W), want, rtol=0, atol=1e-13 * want.abs().max())
    with pytest.raises(ValueError, match="negative"):
        PairMoments(-1, 1, 1.0, amap, device="cpu")
    assert pm.launches == 0


def test_k45_sd3_past_the_old_row_cap_matches_plain_and_fiat_tpu():
    """No row cap: degree 10 with the SV zoo's 32 subcells as pieces of 286
    members (9438 rows; the per-lane layout refused past 454) takes two
    warps a block of 80 KB each.  Its plain version against fiat_tpu's
    PallasMaskedPairMoments in interpret mode, and the kernel's schedule
    replayed on its tables against the plain version, on random and tie
    points."""
    pm, bt, _, _ = _k45_case()
    es = texp.ExpansionSet(tcl.ufc_simplex(3))
    scale = es.get_scale(10)
    big = PairMoments(10, 286, scale, es.affine_mappings[0], pm.geom, pm.parent_map,
                      [(i, 286) for i in range(32)], device="cpu")
    # the tables (12 bytes a piece and a program), then two warps: the
    # slab, 32 piece masks and 4 x 32 16-bit hit counts (384 bytes), the
    # piece sums
    assert (big.rows, big.warps, big.smem) == (286 * 33, 2,
                                               8 * (54 + 2 * (1056 + 48 + 32 * 286)))
    pts = np.vstack([_points(40, 21), _tie_points()])
    wf = np.random.default_rng(22).random(len(pts)) - 0.5
    sums = big(torch.as_tensor(pts), torch.as_tensor(wf)).numpy()
    assert big.launches == 0

    progs = bt.macro_programs
    entries = [{"nexp": 286, "unique": p.es.continuity is not None,
                "maps": [p.es.ref_el.barycentric_map(entity=(3, c), rescale=True)
                         for c in p.cells]} for p in progs]
    parent_map = progs[0].es.ref_el.get_parent().barycentric_map(rescale=True)
    kernel = PallasMaskedPairMoments(progs[0].parent_es, 10, entries, parent_map,
                                     interpret=True, tile=128)
    assert kernel.scale == scale
    bws = np.concatenate([np.asarray(b) for b in jax.jit(kernel.moment_rows)(
        jnp.asarray(pts), jnp.asarray(wf))])
    assert np.abs(sums[286:] - bws).max() <= RTOL_INTERPRET * np.abs(bws).max()

    for grid in ("one_tile_a_warp", "thirty_seven_blocks"):
        got = _replay_k45(big, pts, wf, *K45_GRIDS[grid](len(pts), big))
        assert np.abs(got - sums).max() <= RTOL_PLAIN * np.abs(sums).max()


# -- the f32 engine on tetrahedra (K6's sd = 3 stage) -------------------------

def _f32_zoo(fe, T):
    return [fe.Lagrange(T, p) for p in (1, 3, 5)] + [fe.RaviartThomas(T, 2)]


@pytest.mark.parametrize("order", [0, 1])
def test_f32_tet_engine_matches_fiat_tpu_pallas_interpret(order):
    """As tests/test_device_ops.py:130-144 runs fiat_tpu's engine in 3D, and
    against the port's float64 tables."""
    jzoo, tzoo = _zoos(_f32_zoo)
    pts = _points(700, 17 + order)
    bt = JBatchedTabulator(jzoo, order=order)
    want = np.asarray(PallasZooTabulator(bt, tile=256, interpret=True)(pts))
    tab = device_tabulator(tzoo, order=order, f64=False, device="cpu")
    got = tab(pts)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert tab.kernel.sd == 3 and tab.kernel.launches == 0 and merged_macro(tab) is None
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() <= RTOL_F32
    f32 = tab.tables(pts)
    f64 = device_tabulator(tzoo, order=order, device="cpu")(pts)
    assert list(f32) == list(f64)
    for a in f64:
        scale = f64[a].abs().max().item()
        assert (f32[a].double() - f64[a]).abs().max().item() / scale <= RTOL_F32, a


@pytest.mark.parametrize("variant", ["bubble", "dual"])
def test_f32_tet_variant_recurrences_match_fiat_tpu_pallas_interpret(variant):
    """fiat_tpu's variant shim in 3D: the identity change of basis on a
    degree-4 variant basis."""
    degree = 4
    es = jexp.ExpansionSet(jcl.ufc_simplex(3), variant=variant)
    nexp = es.get_num_members(degree)
    shim = SimpleNamespace(target_es=es, sd=3, max_degree=degree, alpha_mats={},
                           stacked=np.eye(nexp), special_progs=[], special=[], order=0)
    pts = _points(260, 19)
    want = np.asarray(PallasZooTabulator(shim, tile=256, interpret=True)(pts))
    host = np.asarray(es.tabulate(degree, pts))
    tes = texp.ExpansionSet(tcl.ufc_simplex(3), variant=variant)
    tab = F32ZooTabulator.from_arrays(
        stacked=np.eye(nexp), alpha_mats={}, slices=[(0, nexp, (nexp,))], max_degree=degree,
        scale=float(tes.get_scale(degree)), affine_map=tes.affine_mappings[0], variant=variant,
        device="cpu")
    got = tab(pts).numpy()
    assert np.abs(got - want).max() / (np.abs(want).max() + 1.0) <= RTOL_F32
    assert np.abs(got - host).max() / (np.abs(host).max() + 1.0) <= RTOL_F32


@pytest.mark.parametrize("variant", [None, "bubble", "dual"])
def test_f32_tet_phi_tile_replay_on_variant_constants(variant):
    """K6's sd = 3 Phi tile: the streamed recurrence of csrc/dubiner3.cuh on
    the variant's packed constants, each value to its slot, in float32,
    against the plain raw variant recurrence (K1 runs only the plain
    Dubiner constants, so this is the loop's one check on the others)."""
    from fiat_tpu_torch.ops.recurrence import pack_stages
    degree, scale = 5, 0.75
    consts, slots = pack_stages(degree, variant, sd=3)
    consts = consts.astype(np.float32)
    ref = 2.0 * _points(40, 21) - 1.0          # inside the default tetrahedron
    got = np.zeros((len(slots), len(ref)), np.float32)
    for q, x in enumerate(ref.astype(np.float32)):
        for e, v in _dubiner3_values(x, consts, degree, np.float32(scale)):
            got[slots[e], q] = v
    assert got.dtype == np.float32
    want = texp.dubiner_tabulate(3, degree, [ref[:, i] for i in range(3)], scale,
                                 variant=variant, raw=True)
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()


def test_f32_tet_tiles_fit_shared_memory_and_refuse_past_degree_10():
    """tet_lagrange8's plan (165 rows of Phi, padded to 166, at 128 points
    beside a ring of two 28-row A chunks of 128 rows) fits two blocks an
    SM, so one block's recurrence runs beside the other's products; from
    degree 9 the tile takes 64 points, and degree 10 still fits two
    blocks.  A single row tile of degree 3 takes the 64-point tile, four
    blocks an SM.  Past degree 10 the generic instantiation takes the
    degree: at 11 (364 rows) the 64-point tile still fits two blocks."""
    es = texp.ExpansionSet(tcl.ufc_simplex(3))
    amap = es.affine_mappings[0]
    limit = 232448
    for degree, plan in ((3, (64, 20, 4, 4)), (8, (128, 28, 2, 2)), (9, (64, 18, 2, 3)),
                         (10, (64, 40, 2, 2))):
        n = math.comb(degree + 3, 3)
        k6 = ZooF32Kernel([np.eye(n)], degree, 1.0, amap, device="cpu")
        assert k6.plan == plan and k6.kpad == n + n % 2
        assert k6.smem <= limit and plan[3] * (k6.smem + 1024) <= 233472
    k11 = ZooF32Kernel([np.eye(364)], 11, 1.0, amap, device="cpu")
    assert k11.generic and k11.plan == (64, 20, 2, 2) and k11.smem <= limit
    k6 = ZooF32Kernel([np.eye(4)], 1, 1.0, amap, device="cpu")
    with pytest.raises(ValueError, match=r"points must have shape \(npts, 3\)"):
        k6(torch.zeros((4, 2)), torch.zeros(4, dtype=torch.int32), torch.zeros((4, 4)))
