"""K2's plain version and the slice as a whole (device_tabulator on the
CPU, i.e. the kernels' plain versions) against fiat_tpu.

Inputs are numpy arrays made from seeds and handed to both packages; the
fiat_tpu Pallas kernels run in interpret mode, as its own tests run them
(tests/test_device_ops.py)."""

import copy

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fiat_tpu import elements as jfe
from fiat_tpu.core import cells as jcl
from fiat_tpu.ops import moments as jmo
from fiat_tpu.ops.pallas_multiword import FusedMultiwordMatmul
from fiat_tpu.ops.pallas_multiword import FusedZooTabulator as JFusedZooTabulator
from fiat_tpu.ops.tabulate import BatchedTabulator as JBatchedTabulator
from fiat_tpu_torch import device_tabulator
from fiat_tpu_torch import elements as tfe
from fiat_tpu_torch.core import cells as tcl
from fiat_tpu_torch.ops.f32_zoo import F32ZooTabulator
from fiat_tpu_torch.ops.fused_zoo import BucketMatmul, FusedZooTabulator
from fiat_tpu_torch.ops.moments import MomentEngine
from fiat_tpu_torch.ops.tabulate import BatchedTabulator, rebase_program
from chip_smoke import merged_macro


def _zoo(fe, cell):
    return ([fe.Lagrange(cell, p) for p in range(1, 5)]
            + [fe.DiscontinuousLagrange(cell, p) for p in range(1, 4)])


@pytest.fixture(scope="module")
def points():
    rng = np.random.default_rng(42)
    pts = rng.random((200, 2))
    return pts / (pts.sum(axis=1)[:, None] + 1e-9) * rng.random((200, 1))


@pytest.fixture(scope="module")
def zoos():
    return _zoo(jfe, jcl.ufc_simplex(2)), _zoo(tfe, tcl.ufc_simplex(2))


def _max_diff(ref_tabs, got_tabs):
    return max(float(np.abs(np.asarray(r[a]) - np.asarray(g[a])).max())
               for r, g in zip(ref_tabs, got_tabs) for a in r)


def test_bucket_matmul_plain_matches_fused_multiword_interpret():
    rng = np.random.default_rng(5)
    A = rng.standard_normal((700, 66)) * np.exp(rng.standard_normal((700, 1)))
    B = rng.standard_normal((66, 900))
    want = np.asarray(FusedMultiwordMatmul(A, interpret=True, row_block=256,
                                           point_tile=256)(jnp.asarray(B)))
    mm = BucketMatmul([A], device="cpu")
    got = mm(torch.as_tensor(B)).numpy()
    assert mm.launches == 0           # a CPU tensor takes the plain version
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= 1e-12, rel


def test_bucket_matmul_groups_contract_their_prefix():
    rng = np.random.default_rng(6)
    mats = [rng.standard_normal((r, k)) for r, k in ((5, 3), (130, 10), (64, 6))]
    B = rng.standard_normal((12, 77))
    mm = BucketMatmul(mats, device="cpu")
    blocks = mm.views(mm(torch.as_tensor(B)))
    for M, blk in zip(mats, blocks):
        assert np.abs(blk.numpy() - M @ B[:M.shape[1]]).max() <= 1e-13 * np.abs(M).max() * 12
    tiles = mm.tiles.numpy()
    assert (tiles[:, 1] <= BucketMatmul.TILE_ROWS).all()
    assert tiles[:, 1].sum() == mm.total_rows
    # 64-row tiles over the packed rows (5 of width 3, 130 of 10, 64 of 6),
    # each contracting up to its widest row
    assert tiles.tolist() == [[0, 64, 10], [64, 64, 10], [128, 64, 10], [192, 7, 6]]


def test_slice_matches_fiat_tpu_fused_interpret_and_host(points, zoos):
    jzoo, tzoo = zoos
    bt = JBatchedTabulator(jzoo, order=1)
    jfz = JFusedZooTabulator(bt, interpret=True, row_block=256, point_tile=256)
    ref = bt.unpack(jfz(jnp.asarray(points)))

    tab = device_tabulator(tzoo, order=1, device="cpu")
    got = tab.unpack(tab.block_tables(points))
    assert tab.recurrence.launches == 0 and tab.matmul.launches == 0
    assert _max_diff(ref, got) <= 1e-11
    host = [el.tabulate(1, points) for el in tzoo]
    assert _max_diff(host, got) <= 1e-10
    for el, g in zip(tzoo, got):
        for a, t in g.items():
            assert t.dtype == torch.float64
            assert tuple(t.shape) == (el.space_dimension(), len(points))


@pytest.mark.parametrize("f64", [True, False])
def test_device_tabulator_takes_fiat_tpu_keywords(points, zoos, f64):
    """Both front doors called with fiat_tpu's keywords (its TPU-only ones
    are ignored by the port) give the same tables: f64 within the slice's
    1e-11, f32 within fiat_tpu's 5e-6 of the table's max; derivs="jets"
    (which the port once refused) gives fiat_tpu's keys, the value table
    alone at order 1, and its tables; an unknown derivs is a ValueError
    and a keyword neither package takes a TypeError."""
    from fiat_tpu.ops import device_tabulator as jdevice_tabulator
    jzoo, tzoo = zoos
    kw = dict(tile=256, matmul="native", wdtype="bf16", interpret=True, derivs="dmats")
    jtab = jdevice_tabulator(jzoo, order=1, f64=f64, **kw)
    tab = device_tabulator(tzoo, order=1, f64=f64, device="cpu", **kw)
    if f64:
        assert _max_diff(jtab.unpack(jtab(jnp.asarray(points))),
                         tab.unpack(tab.block_tables(points))) <= 1e-11
    else:
        want = np.asarray(jtab(jnp.asarray(points)))
        got = tab(points).numpy()
        assert got.shape == want.shape and tab.kernel.launches == 0
        assert np.abs(got - want).max() <= 5e-6 * np.abs(want).max()
    jets = {**kw, "derivs": "jets"}
    jtab = jdevice_tabulator(jzoo, order=1, f64=f64, **jets)
    tab = device_tabulator(tzoo, order=1, f64=f64, device="cpu", **jets)
    if f64:
        want, got = jtab.unpack(jtab(jnp.asarray(points))), tab.unpack(tab.block_tables(points))
        assert [set(w) for w in want] == [set(g) for g in got] == [{(0, 0)}] * len(tzoo)
        assert _max_diff(want, got) <= 1e-11
    else:
        want, got = np.asarray(jtab(jnp.asarray(points))), tab(points).numpy()
        assert got.shape == want.shape == (tab.plain_rows, len(points))
        assert np.abs(got - want).max() <= 5e-6 * np.abs(want).max()
    with pytest.raises(ValueError, match="derivs"):
        device_tabulator(tzoo, order=1, f64=f64, device="cpu", derivs="taylor")
    with pytest.raises(TypeError, match="row_block"):
        device_tabulator(tzoo, order=1, f64=f64, device="cpu", row_block=256)


def test_from_arrays_on_fiat_tpu_batched_arrays(points, zoos):
    jzoo, _ = zoos
    bt = JBatchedTabulator(jzoo, order=1, matmul="native")
    fz = FusedZooTabulator.from_arrays(
        stacked=bt.stacked, alpha_mats=bt.alpha_mats, slices=bt.slices,
        plain_nexp=bt.plain_nexp, max_degree=bt.max_degree,
        scale=float(bt.target_es.get_scale(bt.max_degree)),
        affine_map=bt.target_es.affine_mappings[0], device="cpu")
    ref = bt.unpack(bt(jnp.asarray(points)))
    got = fz.unpack(fz.block_tables(points))
    assert _max_diff(ref, got) <= 1e-13


def test_concatenated_layout_matches_batched_tabulator(points, zoos):
    _, tzoo = zoos
    bt = BatchedTabulator(tzoo, order=1, device="cpu")
    fz = FusedZooTabulator(bt, device="cpu")
    want, got = bt(points), fz(points)
    assert list(got) == list(want) == [(0, 0), (0, 1), (1, 0)]
    for a in want:
        assert np.abs(got[a].numpy() - want[a].numpy()).max() <= 1e-13
    assert _max_diff(bt.unpack(want), fz.unpack(got)) <= 1e-13


def test_engine_refuses_a_tensor_on_another_device(points, zoos):
    """A tensor is never moved to the engine's device (that would run the
    work on the host while the caller's data is on the card); numpy points
    are host data and go to the engine's device."""
    _, tzoo = zoos
    tab = device_tabulator(tzoo, order=1, device="cpu")
    with pytest.raises(ValueError, match="engine on cpu"):
        tab.block_tables(torch.as_tensor(points, device="meta"))
    assert tab.recurrence.launches == 0 and tab.matmul.launches == 0
    got = tab.block_tables(torch.as_tensor(points))
    want = tab.block_tables(points)
    for a in want:
        for g, w in zip(got[a], want[a]):
            assert torch.equal(g, w)


def test_order_zero_and_state_round_trip(points, zoos):
    _, tzoo = zoos
    bt = BatchedTabulator(tzoo, order=0, device="cpu")
    fz = FusedZooTabulator.from_arrays(**bt.state(), device="cpu")
    assert fz.alphas == [(0, 0)]
    got = fz.unpack(fz.block_tables(points))
    host = [el.tabulate(0, points) for el in tzoo]
    assert _max_diff(host, got) <= 1e-10


def test_degree_zero_member_embeds_with_its_own_scale(points):
    """DG0 is P0 on the plain basis at degree 0, where the constant member
    is exactly 1 (not the degree-n normalisation): the embedding carries
    the scale ratio, as fiat_tpu's does."""
    zoo = [tfe.DiscontinuousLagrange(tcl.ufc_simplex(2), 0), tfe.Lagrange(tcl.ufc_simplex(2), 3)]
    jzoo = [jfe.DiscontinuousLagrange(jcl.ufc_simplex(2), 0), jfe.Lagrange(jcl.ufc_simplex(2), 3)]
    tab = device_tabulator(zoo, order=1, device="cpu")
    assert tab.widths == [1, 10]
    got = tab.unpack(tab.block_tables(points))
    assert _max_diff([el.tabulate(1, points) for el in zoo], got) <= 1e-10
    bt = JBatchedTabulator(jzoo, order=1, matmul="native")
    assert _max_diff(bt.unpack(bt(jnp.asarray(points))), got) <= 1e-13


def test_grouping_refuses_to_drop_real_coefficients(zoos):
    _, tzoo = zoos
    st = BatchedTabulator(tzoo, order=0, device="cpu").state()
    st["plain_nexp"] = {i: 3 for i in st["plain_nexp"]}
    with pytest.raises(ValueError, match="drop real coefficients"):
        FusedZooTabulator.from_arrays(**st, device="cpu")


def test_device_tabulator_raises_for_unported_engines(zoos):
    """``f64=False`` builds the f32 engine (K6, macro elements on K3 in
    float32); a macro program the fused moments kernel (K45) cannot take,
    on a variant parent (which the port once refused naming fiat_tpu's
    per-program fallback, macro_fms), runs its own route, its moments
    held to fiat_tpu's and host's."""
    _, tzoo = zoos
    hct = tfe.HsiehCloughTocher(tcl.ufc_simplex(2), 3)
    assert hct.is_macroelement()
    tab = device_tabulator(tzoo + [hct], order=1, f64=False, device="cpu")
    assert isinstance(tab, F32ZooTabulator)
    assert merged_macro(tab) is not None and merged_macro(tab).dtype == torch.float32
    assert merged_macro(tab).geom[0]["unique"] is False       # order 1: averaged binning
    tab = device_tabulator(tzoo + [hct], order=1, device="cpu")
    assert merged_macro(tab) is not None and tab.special == [len(tzoo)]
    bt = BatchedTabulator(tzoo + [hct], order=0, device="cpu")
    st = bt.state()
    pes = copy.copy(st["macro_programs"][0].parent_es)
    pes.variant = "dual"
    eng = MomentEngine.from_arrays(
        **{**st, "macro_programs": [rebase_program(st["macro_programs"][0], pes)]},
        device="cpu")
    assert [r[0] for r in eng.routes] == ["variant"] and merged_macro(eng) is None
    rng = np.random.default_rng(13)
    pts = rng.random((150, 2)) * 0.5
    wf = rng.random(150)
    jzoo = _zoo(jfe, jcl.ufc_simplex(2)) + [jfe.HsiehCloughTocher(jcl.ufc_simplex(2), 3)]
    jbt = JBatchedTabulator(jzoo, order=0)
    want = np.asarray(jmo.moment_rows(jbt, jnp.asarray(pts), jnp.asarray(wf)))
    got = eng.moment_rows(pts, wf).numpy()
    assert np.abs(got - want).max() <= 1e-12
    lo, hi, _ = bt.slices[-1]
    host = hct.tabulate(0, pts)[(0, 0)] @ wf
    assert np.abs(got[lo:hi] - host).max() <= 1e-12
