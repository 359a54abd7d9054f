"""The tetrahedral f64 tabulation path of the port against fiat_tpu: K1's
plain sd = 3 version, the kernel's stage loop replayed on the packed sd = 3
constants, and the engine (device_tabulator on the CPU, i.e. the kernels'
plain versions) on Lagrange and H(div)/H(curl) zoos on the tetrahedron.

Inputs are numpy arrays made from seeds and handed to both packages; the
fiat_tpu Pallas kernels run in interpret mode, as its own tests run them
(tests/test_device_ops.py)."""

import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fiat_tpu import elements as jfe
from fiat_tpu.core import cells as jcl
from fiat_tpu.core.expansions import ExpansionSet as JExpansionSet
from fiat_tpu.ops.pallas_multiword import FusedZooTabulator as JFusedZooTabulator
from fiat_tpu.ops.tabulate import BatchedTabulator as JBatchedTabulator
from fiat_tpu_torch import device_tabulator
from fiat_tpu_torch import elements as tfe
from fiat_tpu_torch.core import cells as tcl
from fiat_tpu_torch.core import expansions as texp
from fiat_tpu_torch.core.expansions import ExpansionSet
from fiat_tpu_torch.ops.recurrence import DubinerRecurrence, pack_stages
from chip_smoke import merged_macro

RTOL_PLAIN = 1e-13      # the same recurrence in another order of operations
ATOL_FIAT = 1e-10       # engine vs fiat_tpu's interpreted engine (fiat_tpu's own bar)
ATOL_HOST = 1e-11       # engine vs host el.tabulate (both f64, ~1e-13 seen)


def _points(n, seed):
    """Uniform points in the UFC tetrahedron (bench.py's pts3 construction)."""
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 3))
    return pts / (pts.sum(axis=1)[:, None] + 1e-9) * rng.random((n, 1))


PTS = _points(300, 17)


def _max_diff(ref_tabs, got_tabs):
    return max(float(np.abs(np.asarray(r[a]) - np.asarray(g[a])).max())
               for r, g in zip(ref_tabs, got_tabs) for a in r)


@pytest.mark.parametrize("degree", range(0, 9))
def test_plain_tet_recurrence_matches_fiat_tpu(degree):
    want = np.asarray(JExpansionSet(jcl.ufc_simplex(3)).tabulate(degree, PTS))
    es = ExpansionSet(tcl.ufc_simplex(3))
    rec = DubinerRecurrence(3, degree, es.get_scale(degree), es.affine_mappings[0],
                            device="cpu")
    got = rec(torch.as_tensor(PTS))
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
    assert rec.nexp == math.comb(degree + 3, 3)
    assert np.abs(got.numpy() - want).max() / np.abs(want).max() <= RTOL_PLAIN
    assert rec.launches == 0          # a CPU tensor takes the plain version


def _dubiner3_point(x0, x1, x2, consts, slots, n, scale):
    """csrc/dubiner3.cuh's per-point recurrence in numpy, reading the packed
    constants as the kernel does: stage 0 in registers, then every stage-1
    row streamed over q, every stage-1 value starting a stage-2 chain over
    r whose values land on their morton rows."""
    out = np.zeros((math.comb(n + 3, 3),) + np.shape(x0))
    if n == 0:
        out[0] = scale
        return out
    c = consts.reshape(-1, 4)
    nexp2 = (n + 1) * (n + 2) // 2
    c1, c2 = c[n + 1:n + 1 + nexp2], c[n + 1 + nexp2:]

    def step(k, fa, fb, fc, prev, prev2):
        return (k[0] * fa - k[1] * fb) * prev - (k[2] * fc) * prev2

    fb = 0.5 * (x1 + x2)
    fa, fc = x0 + fb + 1.0, fb * fb
    prev2, prev, r0 = 0.0, scale, [scale * c[0, 3]]
    for i in range(1, n + 1):
        v = step(c[i], fa, fb, fc, prev, prev2)
        r0.append(v * c[i, 3])
        prev2, prev = prev, v
    fb1 = 0.5 * (x2 - 1.0)
    fa1, fc1 = x1 + fb1 + 1.0, fb1 * fb1
    fb2 = -1.0
    fa2, fc2 = x2 + fb2 + 1.0, fb2 * fb2
    e1 = e = 0
    for p in range(n + 1):
        prev2, prev = 0.0, r0[p]
        for q in range(n + 1 - p):
            v = prev
            if q > 0:
                v = step(c1[e1], fa1, fb1, fc1, prev, prev2)
                prev2, prev = prev, v
            s2, s = 0.0, v * c1[e1, 3]
            out[slots[e]] = s * c2[e, 3]
            e += 1
            for _ in range(1, n + 1 - p - q):
                w = step(c2[e], fa2, fb2, fc2, s, s2)
                out[slots[e]] = w * c2[e, 3]
                s2, s = s, w
                e += 1
            e1 += 1
    return out


@pytest.mark.parametrize("variant", [None, "bubble", "dual"])
@pytest.mark.parametrize("degree", [0, 1, 2, 5, 8, 10])
def test_packed_sd3_constants_run_the_recurrence(variant, degree):
    """The kernel's stage loop on pack_stages(sd=3)'s constants is
    dubiner_tabulate's raw recurrence, for every variant: the packing is
    checked where the kernel cannot run."""
    consts, slots = pack_stages(degree, variant, sd=3)
    ref = _points(200, degree) * 2.0 - 1.0
    got = _dubiner3_point(ref[:, 0], ref[:, 1], ref[:, 2], consts, slots, degree, 1.25)
    want = texp.dubiner_tabulate(3, degree, [ref[:, 0], ref[:, 1], ref[:, 2]], 1.25,
                                 variant=variant, raw=True)
    assert np.abs(got - want).max() <= RTOL_PLAIN * np.abs(want).max()


def test_pack_stages_sd3_layout_covers_every_member_once():
    for n in (1, 2, 5, 8, 10):
        consts, slots = pack_stages(n, sd=3)
        nexp2, nexp3 = math.comb(n + 2, 2), math.comb(n + 3, 3)
        assert consts.shape == (4 * (n + 1 + nexp2 + nexp3),)
        assert sorted(slots.tolist()) == list(range(nexp3))
        # slots are the morton rows of (p, q, r) in (p, q, r) order
        want = [texp.morton_index3(p, q, r) for p in range(n + 1) for q in range(n + 1 - p)
                for r in range(n + 1 - p - q)]
        assert slots.tolist() == want
    with pytest.raises(NotImplementedError, match="sd = 1, 2 and 3"):
        pack_stages(2, sd=4)


def _lagrange(fe, cell):
    return [fe.Lagrange(cell, 4)]


def _hdiv(fe, cell):
    return ([fe.RaviartThomas(cell, k) for k in (1, 2)] + [fe.Nedelec(cell, k) for k in (1, 2)]
            + [fe.BrezziDouglasMarini(cell, k) for k in (1, 2)])


@pytest.mark.parametrize("make", [_lagrange, _hdiv], ids=["lagrange4", "rt_n_bdm_1_2"])
def test_tet_engine_matches_fiat_tpu_interpret_and_host(make):
    jzoo, tzoo = make(jfe, jcl.ufc_simplex(3)), make(tfe, tcl.ufc_simplex(3))
    bt = JBatchedTabulator(jzoo, order=1)
    jfz = JFusedZooTabulator(bt, interpret=True, row_block=256, point_tile=256)
    ref = bt.unpack(jfz(jnp.asarray(PTS)))
    tab = device_tabulator(tzoo, order=1, device="cpu")
    got = tab.unpack(tab.block_tables(PTS))
    assert (tab.recurrence.launches, tab.matmul.launches) == (0, 0)
    assert tab.recurrence.sd == 3 and tab.features is None
    assert _max_diff(ref, got) <= ATOL_FIAT
    assert _max_diff([el.tabulate(1, PTS) for el in tzoo], got) <= ATOL_HOST


def test_hdiv_tet_groups_by_width():
    tab = device_tabulator(_hdiv(tfe, tcl.ufc_simplex(3)), order=1, device="cpu")
    assert tab.widths == [4, 10] and len(tab.alphas) == 4


def test_lagrange8_tet_engine_matches_fiat_tpu_native_batched():
    """tet_lagrange8 itself (K = 165, past the triangle's widths) against
    fiat_tpu's BatchedTabulator in native f64."""
    bt = JBatchedTabulator([jfe.Lagrange(jcl.ufc_simplex(3), 8)], order=1, matmul="native")
    ref = bt.unpack(bt(jnp.asarray(PTS)))
    tab = device_tabulator([tfe.Lagrange(tcl.ufc_simplex(3), 8)], order=1, device="cpu")
    assert tab.widths == [165] and tab.matmul.max_k == 165
    got = tab.unpack(tab.block_tables(PTS))
    assert _max_diff(ref, got) <= ATOL_HOST


def test_f32_and_moments_engines_refuse_tetrahedra_naming_their_sd3_stage():
    """Nothing is refused any more: plain tet zoos run on both engines (K6's
    and K45's sd = 3 stages), and so do the f32 tables and the
    interpolation of a tet macro zoo (K3's sd = 3 stage), against host."""
    from fiat_tpu_torch.ops.moments import MomentEngine
    from fiat_tpu_torch.ops.tabulate import BatchedTabulator
    T = tcl.ufc_simplex(3)
    plain, macro = [tfe.Lagrange(T, 2)], [tfe.Lagrange(T, 2), tfe.Lagrange(T, 2, variant="alfeld")]
    assert device_tabulator(plain, order=0, f64=False, device="cpu").kernel.sd == 3
    tab = device_tabulator(macro, order=0, f64=False, device="cpu")
    assert tab.kernel.sd == merged_macro(tab).sd == 3
    tables = tab.tables(PTS)[(0, 0, 0)]
    host = np.vstack([el.tabulate(0, PTS)[(0, 0, 0)] for el in macro])
    assert np.abs(tables.numpy() - host).max() <= 5e-5 * (np.abs(host).max() + 1.0)
    eng = MomentEngine(BatchedTabulator(macro, order=0, device="cpu"), device="cpu")
    assert eng.moments.sd == 3
    c = np.random.default_rng(1).random(eng.rows) - 0.5
    assert np.abs(eng.interpolate_rows(PTS, c).numpy() - c @ host).max() <= 1e-12
