"""The f32 engine (``ops/f32_zoo.F32ZooTabulator``: K6's and K3's float32
plain versions) against fiat_tpu's ``PallasZooTabulator`` in interpret mode,
as fiat_tpu's own tests run it (tests/test_device_ops.py), and against the
port's float64 tables.

Inputs are numpy arrays made from seeds and handed to both packages."""

from types import SimpleNamespace

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fiat_tpu import elements as jfe
from fiat_tpu.core import cells as jcl
from fiat_tpu.core import expansions as jexp
from fiat_tpu.ops.pallas_tabulate import PallasZooTabulator
from fiat_tpu.ops.tabulate import BatchedTabulator as JBatchedTabulator
from fiat_tpu_torch import device_tabulator
from fiat_tpu_torch import elements as tfe
from fiat_tpu_torch.core import cells as tcl
from fiat_tpu_torch.core import expansions as texp
from fiat_tpu_torch.ops.f32_zoo import F32ZooTabulator, ZooF32Kernel
from fiat_tpu_torch.ops.tabulate import BatchedTabulator

RTOL = 5e-6         # fiat_tpu's f32 bar (tests/test_device_ops.py:143-144)
MACRO_TOL = 5e-5    # its macro bar, relative to max abs + 1 (:586-589)


def _rng(seed):
    return np.random.default_rng(seed)


def _nodal_zoo(fe, T):
    return [fe.Lagrange(T, p) for p in (1, 3, 5)] + [fe.RaviartThomas(T, 2)]


def _macro_zoo(fe, T):
    return [fe.CubicHermite(T), fe.Morley(T), fe.HsiehCloughTocher(T, 3),
            fe.QuadraticPowellSabin6(T)]


def _special_points():
    c = np.array([1.0, 1.0]) / 3.0
    ends = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0], [0.5, 0.5], [0.0, 0.5], [0.5, 0.0]])
    t = np.array([0.0, 0.125, 0.25, 0.5, 0.75])[:, None]
    return np.vstack([c[None]] + [v + t * (c - v) for v in ends])


def test_plain_rows_match_fiat_tpu_pallas_interpret():
    pts = _rng(0).random((700, 2)) / 2
    bt = JBatchedTabulator(_nodal_zoo(jfe, jcl.ufc_simplex(2)), order=0)
    want = np.asarray(PallasZooTabulator(bt, tile=256, interpret=True)(pts))
    tab = device_tabulator(_nodal_zoo(tfe, tcl.ufc_simplex(2)), order=0, f64=False, device="cpu")
    got = tab(pts)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert tab.kernel.launches == 0            # CPU tensors: the plain version
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() <= RTOL
    ref = np.asarray(bt(jnp.asarray(pts))[(0, 0)])
    assert np.abs(got.numpy() - ref).max() / np.abs(ref).max() <= RTOL


@pytest.mark.parametrize("variant", ["bubble", "dual"])
def test_variant_recurrences_match_fiat_tpu_pallas_interpret(variant):
    """The same SimpleNamespace shim as fiat_tpu's variant test, triangle
    only: the identity change of basis on a degree-5 variant basis."""
    degree = 5
    es = jexp.ExpansionSet(jcl.ufc_simplex(2), variant=variant)
    nexp = es.get_num_members(degree)
    shim = SimpleNamespace(target_es=es, sd=2, max_degree=degree, alpha_mats={},
                           stacked=np.eye(nexp), special_progs=[], special=[], order=0)
    pts = _rng(1).random((260, 2)) / 2
    want = np.asarray(PallasZooTabulator(shim, tile=256, interpret=True)(pts))
    host = np.asarray(es.tabulate(degree, pts))
    tes = texp.ExpansionSet(tcl.ufc_simplex(2), variant=variant)
    tab = F32ZooTabulator.from_arrays(
        stacked=np.eye(nexp), alpha_mats={}, slices=[(0, nexp, (nexp,))], max_degree=degree,
        scale=float(tes.get_scale(degree)), affine_map=tes.affine_mappings[0], variant=variant,
        device="cpu")
    got = tab(pts).numpy()
    assert np.abs(got - want).max() / (np.abs(want).max() + 1.0) <= RTOL
    assert np.abs(got - host).max() / (np.abs(host).max() + 1.0) <= RTOL


def test_macro_zoo_matches_host_and_fiat_tpu_pallas_interpret():
    pts = np.vstack([_rng(2).random((300, 2)) / 2, _special_points()])
    bt = JBatchedTabulator(_macro_zoo(jfe, jcl.ufc_simplex(2)), order=1)
    want = PallasZooTabulator(bt, tile=256, interpret=True).tables(pts)
    tzoo = _macro_zoo(tfe, tcl.ufc_simplex(2))
    tab = device_tabulator(tzoo, order=1, f64=False, device="cpu")
    got = tab.tables(pts)
    assert list(got) == list(want)
    for a in want:
        w = np.asarray(want[a])
        assert np.abs(got[a].numpy() - w).max() / (np.abs(w).max() + 1.0) <= MACRO_TOL, a
    assert (tab.kernel.launches, tab.macro.launches) == (0, 0)
    for el, t in zip(tzoo, BatchedTabulator(tzoo, order=1, device="cpu").unpack(got)):
        host = el.tabulate(1, pts)
        for a in host:
            err = np.abs(t[a].numpy().reshape(host[a].shape) - host[a]).max()
            assert err / (np.abs(host[a]).max() + 1.0) <= MACRO_TOL, (type(el).__name__, a)


def test_from_arrays_on_fiat_tpu_arrays_matches_the_ports():
    pts = np.vstack([_rng(3).random((200, 2)) / 2, _special_points()])
    jzoo = _nodal_zoo(jfe, jcl.ufc_simplex(2)) + _macro_zoo(jfe, jcl.ufc_simplex(2))
    tzoo = _nodal_zoo(tfe, tcl.ufc_simplex(2)) + _macro_zoo(tfe, tcl.ufc_simplex(2))
    bt = JBatchedTabulator(jzoo, order=1, matmul="native")
    jtab = F32ZooTabulator.from_arrays(
        stacked=bt.stacked, alpha_mats=bt.alpha_mats, slices=bt.slices,
        plain_nexp=bt.plain_nexp, max_degree=bt.max_degree,
        scale=float(bt.target_es.get_scale(bt.max_degree)),
        affine_map=bt.target_es.affine_mappings[0], macro_programs=bt.macro_programs, device="cpu")
    ttab = device_tabulator(tzoo, order=1, f64=False, device="cpu")
    got, want = jtab.tables(pts), ttab.tables(pts)
    for a in want:
        assert np.abs(got[a].numpy() - want[a].numpy()).max() <= 1e-6 * np.abs(
            want[a].numpy()).max()


@pytest.mark.parametrize("degree", [0, 1, 10])
def test_single_degrees_against_float64_tables(degree):
    """Lagrange / DG of one degree, values and first derivatives, against
    the port's float64 engine: degree 0 is the scale quirk, 10 the
    full_zoo's widest basis."""
    T = tcl.ufc_simplex(2)
    zoo = ([tfe.DiscontinuousLagrange(T, 0)] if degree == 0
           else [tfe.Lagrange(T, degree), tfe.DiscontinuousLagrange(T, degree)])
    pts = _rng(4).random((500, 2)) / 2
    f32 = device_tabulator(zoo, order=1, f64=False, device="cpu").tables(pts)
    f64 = device_tabulator(zoo, order=1, device="cpu")(pts)
    for a in f64:
        scale = f64[a].abs().max().item() or 1.0
        assert (f32[a].double() - f64[a]).abs().max().item() / scale <= RTOL, a


def test_call_tables_and_unpack_share_rows():
    pts = _rng(5).random((130, 2)) / 2
    tzoo = _nodal_zoo(tfe, tcl.ufc_simplex(2)) + _macro_zoo(tfe, tcl.ufc_simplex(2))
    tab = device_tabulator(tzoo, order=1, f64=False, device="cpu")
    plain, tables = tab.unpack(tab(pts)), tab.tables(pts)
    assert list(plain) == list(tables) == [(0, 0), (0, 1), (1, 0)]
    for a in plain:
        assert tuple(tables[a].shape) == (tab.rows, len(pts))
        assert torch.equal(plain[a], tables[a][:tab.plain_rows])
    f64 = device_tabulator(tzoo, order=1, device="cpu")(pts)
    for a in f64:
        assert (tables[a].double() - f64[a]).abs().max().item() <= MACRO_TOL * (
            f64[a].abs().max().item() + 1.0)


def test_engine_checks_device_cell_and_inputs():
    T = tcl.ufc_simplex(2)
    tab = device_tabulator([tfe.Lagrange(T, 2)], order=1, f64=False, device="cpu")
    pts = _rng(6).random((40, 2)) / 2
    with pytest.raises(ValueError, match="engine on cpu"):
        tab.tables(torch.as_tensor(pts, device="meta"))
    with pytest.raises(ValueError, match="points must have shape"):
        tab(np.zeros((4, 3)))
    out = torch.empty((tab.kernel.total_rows, 4))
    with pytest.raises(TypeError, match="float32"):
        tab.kernel(torch.zeros((4, 2), dtype=torch.float64), tab.dst_plain, out)
    assert tab.kernel.launches == 0
    # tetrahedra run on K6's sd = 3 stage, a tet macro zoo's macro rows on K3's
    T3 = tcl.ufc_simplex(3)
    tet = device_tabulator([tfe.Lagrange(T3, 2), tfe.Lagrange(T3, 2, variant="alfeld")],
                           order=0, f64=False, device="cpu")
    assert tet.kernel.sd == tet.macro.sd == 3
    with pytest.raises(ValueError, match="points must have shape"):
        tet.macro(torch.zeros((4, 2)))
    with pytest.raises(NotImplementedError, match="variant"):
        ZooF32Kernel([np.eye(3)], 1, 1.0, (np.eye(2), np.zeros(2)), variant="other")


def test_float32_binning_equals_fiat_tpu_masks():
    """K3's float32 binning (tolerance 1e-5) takes the same subcells as
    fiat_tpu's float32 masks on random points and on points exactly on
    interior edges, the barycentre and the Powell-Sabin centre."""
    from fiat_tpu.core import macro as jmacro
    from fiat_tpu_torch.core import macro as tmacro
    pts = np.vstack([_rng(7).random((400, 2)), _special_points()]).astype(np.float32)
    for split in ("AlfeldSplit", "PowellSabinSplit"):
        tcell = getattr(tmacro, split)(tcl.ufc_simplex(2))
        jcell = getattr(jmacro, split)(jcl.ufc_simplex(2))
        for unique in (True, False):
            g, _ = texp.partition_of_unity_masks(tcell, torch.as_tensor(pts), unique=unique,
                                                 raw=True)
            w, _ = jexp.partition_of_unity_masks(jcell, jnp.asarray(pts), unique=unique,
                                                 raw=True)
            for gm, wm in zip(g, w):
                assert np.array_equal(gm.numpy(), np.asarray(wm)), (split, unique)
