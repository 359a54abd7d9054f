"""Moments and interpolation (``ops/moments.py``) and the plain version of
K45 (``ops/moment_kernel.PairMoments``) against fiat_tpu on the CPU.

Inputs are numpy arrays made from seeds and handed to both packages;
fiat_tpu's ``moment_rows`` and ``interpolate_rows`` run their f64 XLA
fallback on the CPU, as its own tests run them (tests/test_device_ops.py)."""

import copy
import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fiat_tpu import elements as jfe
from fiat_tpu.core import cells as jcl
from fiat_tpu.ops import moments as jmo
from fiat_tpu.ops.tabulate import BatchedTabulator as JBatchedTabulator
from fiat_tpu_torch import elements as tfe
from fiat_tpu_torch.core import cells as tcl
from fiat_tpu_torch.ops import moments as tmo
from fiat_tpu_torch.ops.moments import MomentEngine
from fiat_tpu_torch.ops.tabulate import BatchedTabulator, rebase_program
from chip_smoke import merged_macro

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_macro import PARENT_EDITS  # noqa: E402
from test_torch_tet_dual import K45_GRIDS, _replay_k45  # noqa: E402

ATOL = 1e-12        # against fiat_tpu (f64 on both sides; fiat_tpu's own bar)
RTOL_PLAIN = 1e-13  # the same sums in another order of operations


def _special_points():
    """Points exactly on the interior edges of the Alfeld and Powell-Sabin
    splits, on the Alfeld barycentre (= the Powell-Sabin centre), on the
    edge midpoints and on the vertices."""
    c = np.array([1.0, 1.0]) / 3.0
    ends = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [0.5, 0.5], [0.0, 0.5], [0.5, 0.0]])
    t = np.array([0.0, 0.125, 0.25, 0.5, 0.75])[:, None]
    return np.vstack([c[None]] + [v + t * (c - v) for v in ends])


def _moment_zoo(fe, T):
    return [fe.Lagrange(T, 3), fe.HsiehCloughTocher(T, 3), fe.CubicHermite(T),
            fe.QuadraticPowellSabin6(T)]


def _interp_zoo(fe, T):
    return [fe.Lagrange(T, 4), fe.HsiehCloughTocher(T, 3), fe.CubicHermite(T)]


def _zoos(make):
    return make(jfe, jcl.ufc_simplex(2)), make(tfe, tcl.ufc_simplex(2))


def _inputs(seed, n=400):
    rng = np.random.default_rng(seed)
    pts = np.vstack([rng.random((n, 2)) / 2, _special_points()])
    return rng, pts, rng.random(len(pts))


def test_moment_rows_match_fiat_tpu_and_host():
    jzoo, tzoo = _zoos(_moment_zoo)
    _, pts, wf = _inputs(3)
    bt = JBatchedTabulator(jzoo, order=0)
    want = np.asarray(jax.jit(lambda q, w: jmo.moment_rows(bt, q, w))(
        jnp.asarray(pts), jnp.asarray(wf)))
    tb = BatchedTabulator(tzoo, order=0, device="cpu")
    got = tmo.moment_rows(tb, pts, wf)
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
    assert np.abs(got.numpy() - want).max() <= ATOL
    eng = tb._moment_engine
    assert eng.moments.launches == 0           # CPU tensors: the plain version
    # fiat_tpu's own check: the per-element host contraction
    for el, m in zip(tzoo, tmo.unpack_moments(tb, got)):
        tab = el.tabulate(0, pts)[(0, 0)].reshape(-1, len(pts))
        assert m.numel() == tab.shape[0]
        assert np.abs((tab @ wf).reshape(m.shape) - m.numpy()).max() <= ATOL, type(el).__name__


def test_interpolate_rows_match_fiat_tpu_and_host():
    jzoo, tzoo = _zoos(_interp_zoo)
    rng, pts, _ = _inputs(9, n=300)
    bt = JBatchedTabulator(jzoo, order=0)
    rows = max(hi for _lo, hi, _s in bt.slices)
    c = rng.random(rows) - 0.5
    want = np.asarray(jax.jit(lambda q, cc: jmo.interpolate_rows(bt, q, cc))(
        jnp.asarray(pts), jnp.asarray(c)))
    tb = BatchedTabulator(tzoo, order=0, device="cpu")
    got = tmo.interpolate_rows(tb, pts, c)
    assert tuple(got.shape) == (len(pts),)
    assert np.abs(got.numpy() - want).max() <= ATOL
    host = np.zeros(len(pts))
    for el, (lo, hi, _) in zip(tzoo, tb.slices):
        host += c[lo:hi] @ el.tabulate(0, pts)[(0, 0)].reshape(hi - lo, len(pts))
    assert np.abs(got.numpy() - host).max() <= ATOL


def test_k45_plain_pieces_are_the_explicit_contractions():
    """pw = Phi @ wf over the zoo's basis and, per macro program, bw = the
    masked parent stack (fiat_tpu's ``b_stack``, order 0) @ wf; both
    programs here have the zoo's scale, so no ratio enters."""
    jzoo, tzoo = _zoos(_moment_zoo)
    _, pts, wf = _inputs(5)
    bt = JBatchedTabulator(jzoo, order=0)
    eng = MomentEngine(BatchedTabulator(tzoo, order=0, device="cpu"), device="cpu")
    pm = eng.moments
    sums = pm(torch.as_tensor(pts), torch.as_tensor(wf)).numpy()
    assert pm.rows == len(sums) == 10 + 3 * 10 + 6 * 6
    phi = np.asarray(bt._expansion_tables(jnp.asarray(pts))[(0, 0)])
    want = [phi @ wf] + [np.asarray(p.b_stack(jnp.asarray(pts), 0)) @ wf
                         for p in bt.macro_programs]
    want = np.concatenate(want)
    assert np.abs(sums - want).max() <= 1e-13 * np.abs(want).max()


def _full_zoo_shapes(fe, T):
    """full_zoo's K45 shapes: degree 10 (66 plain rows), HCT 3 and PS6 (3
    pieces of 10 and 6 of 6 members, 132 rows)."""
    return [fe.Lagrange(T, 10), fe.HsiehCloughTocher(T, 3), fe.QuadraticPowellSabin6(T)]


@pytest.mark.parametrize("grid", sorted(K45_GRIDS))
@pytest.mark.parametrize("where", ["random", "tie"])
def test_k45_sd2_kernel_loop_on_its_packed_tables_matches_plain(where, grid):
    """The kernel cannot run here: its schedule on triangles (slab chunks of
    32 entries, lane-owned members, block and last-block reductions)
    replayed on the packed constants and binning tables equals the plain
    version, on random points and on points where subcells meet."""
    pm = MomentEngine(BatchedTabulator(_full_zoo_shapes(tfe, tcl.ufc_simplex(2)), order=0,
                                       device="cpu"), device="cpu").moments
    assert (pm.sd, pm.degree, pm.nplain, pm.rows, pm.warps) == (2, 10, 66, 132, 8)
    assert pm.piece_nexp == [10] * 3 + [6] * 6
    rng = np.random.default_rng(31)
    pts = rng.random((300, 2)) / 2 if where == "random" else _special_points()
    wf = rng.random(len(pts)) - 0.25
    want = pm(torch.as_tensor(pts), torch.as_tensor(wf)).numpy()
    got = _replay_k45(pm, pts, wf, *K45_GRIDS[grid](len(pts), pm))
    assert np.abs(got - want).max() <= RTOL_PLAIN * np.abs(want).max()


def test_engine_from_fiat_tpu_arrays_matches_the_ports():
    jzoo, tzoo = _zoos(_moment_zoo)
    rng, pts, wf = _inputs(11, n=200)
    bt = JBatchedTabulator(jzoo, order=0)
    jeng = MomentEngine.from_arrays(
        stacked=bt.stacked, slices=bt.slices, max_degree=bt.max_degree,
        scale=float(bt.target_es.get_scale(bt.max_degree)),
        affine_map=bt.target_es.affine_mappings[0], macro_programs=bt.macro_programs, device="cpu")
    teng = MomentEngine(BatchedTabulator(tzoo, order=0, device="cpu"), device="cpu")
    assert np.abs(jeng.moment_rows(pts, wf).numpy()
                  - teng.moment_rows(pts, wf).numpy()).max() <= 1e-13
    c = rng.random(teng.rows) - 0.5
    assert np.abs(jeng.interpolate_rows(pts, c).numpy()
                  - teng.interpolate_rows(pts, c).numpy()).max() <= 1e-13


def test_zoo_moments_folds_the_field_and_unpacks_per_element():
    jzoo, tzoo = _zoos(_moment_zoo)
    rng, pts, w = _inputs(13, n=150)
    f = rng.standard_normal(len(pts))
    bt = JBatchedTabulator(jzoo, order=0)
    want = np.asarray(jmo.zoo_moments(bt, jnp.asarray(pts), jnp.asarray(w), jnp.asarray(f)))
    tb = BatchedTabulator(tzoo, order=0, device="cpu")
    got = tmo.zoo_moments(tb, pts, w, f)
    assert np.abs(got.numpy() - want).max() <= ATOL
    for g, j in zip(tmo.unpack_moments(tb, got), jmo.unpack_moments(bt, want)):
        assert tuple(g.shape) == j.shape
    assert np.abs(tmo.zoo_moments(tb, pts, w * f).numpy() - got.numpy()).max() <= 1e-13


def test_plain_zoo_moments_without_macro_programs():
    jzoo = [jfe.Lagrange(jcl.ufc_simplex(2), p) for p in (1, 2, 5)] + [
        jfe.RaviartThomas(jcl.ufc_simplex(2), 2)]
    tzoo = [tfe.Lagrange(tcl.ufc_simplex(2), p) for p in (1, 2, 5)] + [
        tfe.RaviartThomas(tcl.ufc_simplex(2), 2)]
    rng, pts, wf = _inputs(17, n=120)
    bt = JBatchedTabulator(jzoo, order=0)
    tb = BatchedTabulator(tzoo, order=0, device="cpu")
    got = tmo.moment_rows(tb, pts, wf)
    want = np.asarray(jmo.moment_rows(bt, jnp.asarray(pts), jnp.asarray(wf)))
    assert np.abs(got.numpy() - want).max() <= ATOL
    assert merged_macro(tb._moment_engine) is None
    c = rng.random(len(got)) - 0.5
    want = np.asarray(jmo.interpolate_rows(bt, jnp.asarray(pts), jnp.asarray(c)))
    assert np.abs(tmo.interpolate_rows(tb, pts, c).numpy() - want).max() <= ATOL


def test_engine_is_cached_and_refuses_a_tensor_on_another_device():
    _, tzoo = _zoos(_moment_zoo)
    _, pts, wf = _inputs(19, n=50)
    tb = BatchedTabulator(tzoo, order=0, device="cpu")
    tmo.moment_rows(tb, pts, wf)
    eng = tb._moment_engine
    tmo.interpolate_rows(tb, pts, np.zeros(eng.rows))
    assert tb._moment_engine is eng
    with pytest.raises(ValueError, match="engine on cpu"):
        tmo.moment_rows(tb, torch.as_tensor(pts, device="meta"), wf)
    with pytest.raises(ValueError, match="engine on cpu"):
        tmo.moment_rows(tb, pts, torch.as_tensor(wf, device="meta"))
    with pytest.raises(ValueError, match="wf must have shape"):
        tmo.moment_rows(tb, pts, wf[:-1])
    with pytest.raises(ValueError, match="coefficients must have shape"):
        tmo.interpolate_rows(tb, pts, np.zeros(eng.rows + 1))
    assert (eng.moments.launches, eng.recurrence.launches, merged_macro(eng).launches) == (0, 0, 0)


def _edited_programs(bt, attr, value):
    """``bt``'s macro programs with the first on its parent's basis edited
    by ``attr`` = ``value`` (``test_torch_macro.PARENT_EDITS``), its tall
    matrix re-expressed there (``rebase_program``)."""
    pes = copy.copy(bt.macro_programs[0].parent_es)
    setattr(pes, attr, value)
    return [rebase_program(bt.macro_programs[0], pes), *bt.macro_programs[1:]]


@pytest.mark.parametrize("attr,value", PARENT_EDITS, ids=[a for a, _ in PARENT_EDITS])
def test_engine_refuses_programs_k45_cannot_take(attr, value):
    """Programs off the zoo's parent basis (which the port once refused)
    run by route: another cell map or scale on a K45 of its own (and a K3
    of its own for interpolation), a variant parent's masked parent by the
    weights in PyTorch.  Moments held to fiat_tpu's ``moment_rows`` on the
    same edited programs at 1e-12, and both directions to host."""
    jzoo, tzoo = _zoos(_moment_zoo)
    rng, pts, wf = _inputs(23, n=300)
    tb = BatchedTabulator(tzoo, order=0, device="cpu")
    jbt = JBatchedTabulator(jzoo, order=0)
    eng = MomentEngine.from_arrays(**{**tb.state(),
                                      "macro_programs": _edited_programs(tb, attr, value)},
                                   device="cpu")
    variant = attr == "variant"
    assert len(eng.moment_kernels) == (1 if variant else 2)
    assert len(eng.macros) == (1 if variant else 2)
    jbt.macro_programs = _edited_programs(jbt, attr, value)
    want = np.asarray(jax.jit(lambda q, w: jmo.moment_rows(jbt, q, w))(
        jnp.asarray(pts), jnp.asarray(wf)))
    got = eng.moment_rows(pts, wf).numpy()
    assert np.abs(got - want).max() <= ATOL
    c = rng.random(eng.rows) - 0.5
    u = eng.interpolate_rows(pts, c).numpy()
    host_u = np.zeros(len(pts))
    for el, (lo, hi, _) in zip(tzoo, tb.slices):
        tab = el.tabulate(0, pts)[(0, 0)].reshape(hi - lo, len(pts))
        assert np.abs(tab @ wf - got[lo:hi]).max() <= ATOL, type(el).__name__
        host_u += c[lo:hi] @ tab
    assert np.abs(u - host_u).max() <= ATOL
    assert all(pm.launches == 0 for pm in eng.moment_kernels)


def test_engine_refuses_mixed_parent_expansion_types():
    """A program whose parent is of another expansion-set type (which the
    port once refused) makes a group of its own, on a K45 of its own."""
    jzoo, tzoo = _zoos(_moment_zoo)
    _, pts, wf = _inputs(29, n=300)
    tb = BatchedTabulator(tzoo, order=0, device="cpu")
    st = tb.state()
    odd = copy.copy(st["macro_programs"][1])

    class OtherSet(type(odd.parent_es)):
        pass

    odd.parent_es = copy.copy(odd.parent_es)
    odd.parent_es.__class__ = OtherSet
    eng = MomentEngine.from_arrays(**{**st, "macro_programs": [st["macro_programs"][0], odd]},
                                   device="cpu")
    assert len(eng.moment_kernels) == 2 and [r[1] for r in eng.routes] == [[0], [1]]
    bt = JBatchedTabulator(jzoo, order=0)
    want = np.asarray(jax.jit(lambda q, w: jmo.moment_rows(bt, q, w))(
        jnp.asarray(pts), jnp.asarray(wf)))
    assert np.abs(eng.moment_rows(pts, wf).numpy() - want).max() <= ATOL
