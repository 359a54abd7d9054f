"""K1's plain version (the torch path of the Dubiner recurrence) and the
expansion-set host math of the port, against fiat_tpu.

Inputs are numpy arrays made from seeds and handed to both packages; the
fiat_tpu Pallas kernel runs in interpret mode, as its own tests run it."""

import math

import numpy as np
import pytest
import torch
import jax.numpy as jnp

from fiat_tpu.core import cells as jcl
from fiat_tpu.core.expansions import ExpansionSet as JExpansionSet
from fiat_tpu.ops.pallas_recurrence import PallasSliceRecurrence
from fiat_tpu_torch.core import cells as tcl
from fiat_tpu_torch.core import expansions as texp
from fiat_tpu_torch.core.expansions import ExpansionSet
from fiat_tpu_torch.ops.recurrence import UNROLLED_DEGREE, DubinerRecurrence, pack_stages

PTS = np.random.default_rng(11).random((300, 2)) * 0.45


def _recurrence(es, n):
    return DubinerRecurrence(2, n, es.get_scale(n), es.affine_mappings[0], device="cpu")


@pytest.mark.parametrize("degree", range(0, 11))
def test_plain_recurrence_matches_fiat_tpu(degree):
    want = np.asarray(JExpansionSet(jcl.ufc_simplex(2))._tabulate_on_cell(degree, PTS)[(0, 0)])
    rec = _recurrence(ExpansionSet(tcl.ufc_simplex(2)), degree)
    got = rec(torch.as_tensor(PTS))
    assert got.dtype == torch.float64 and tuple(got.shape) == want.shape
    rel = np.abs(got.numpy() - want).max() / np.abs(want).max()
    assert rel <= 1e-13, rel
    assert rec.launches == 0          # a CPU tensor takes the plain version


def test_plain_recurrence_matches_pallas_slice_recurrence_interpret():
    """Against the TPU kernel's windows, summed.  XLA:CPU contracts the
    error-free transforms into FMAs, so the df32 pipeline is only
    f32-accurate here: the JAX package's own bound is 1e-5."""
    rec = PallasSliceRecurrence(JExpansionSet(jcl.ufc_simplex(2)), 7, interpret=True, tile=256)
    slices, sB = rec(jnp.asarray(PTS))
    want = sum(np.asarray(s, np.float64) for s in slices) * np.asarray(sB, np.float64)
    got = _recurrence(ExpansionSet(tcl.ufc_simplex(2)), 7)(torch.as_tensor(PTS)).numpy()
    rel = np.abs(got - want).max() / np.abs(want).max()
    assert rel <= 1e-5, rel


@pytest.mark.parametrize("degree", [1, 4, 10])
def test_dmats_match_fiat_tpu(degree):
    want = JExpansionSet(jcl.ufc_simplex(2)).get_dmats(degree)
    got = ExpansionSet(tcl.ufc_simplex(2)).get_dmats(degree)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= 1e-12 * max(1.0, np.abs(want).max())


@pytest.mark.parametrize("variant,scale", [("bubble", 1), (None, None)])
def test_jet_tabulation_matches_fiat_tpu_numpy_and_torch(variant, scale):
    kw = {"variant": variant} if variant else {}
    if scale is not None:
        kw["scale"] = scale
    ref = JExpansionSet(jcl.ufc_simplex(2), **kw)._tabulate_on_cell(6, PTS[:40], order=2)
    es = ExpansionSet(tcl.ufc_simplex(2), **kw)
    host = es._tabulate_on_cell(6, PTS[:40], order=2)
    dev = es._tabulate_on_cell(6, torch.as_tensor(PTS[:40]), order=2)
    assert set(host) == set(ref) == set(dev)
    for alpha in ref:
        want = np.asarray(ref[alpha])
        scale_ = max(1.0, np.abs(want).max())
        assert np.abs(host[alpha] - want).max() <= 1e-13 * scale_, alpha
        assert isinstance(dev[alpha], torch.Tensor)
        assert np.abs(dev[alpha].numpy() - want).max() <= 1e-13 * scale_, alpha


def test_pack_stages_covers_every_member_once():
    for n in (1, 2, 5, 10):
        consts, slots = pack_stages(n)
        nexp = (n + 1) * (n + 2) // 2
        assert consts.shape == (4 * (n + 1) + 4 * nexp,)
        assert sorted(slots.tolist()) == list(range(nexp))


def _dubiner2_point(x0, x1, consts, slots, n, scale):
    """csrc/dubiner2.cuh's per-point recurrence in numpy, reading the packed
    constants as the kernels do; values land on their morton rows."""
    out = np.zeros(((n + 1) * (n + 2) // 2,) + np.shape(x0))
    if n == 0:
        out[0] = scale
        return out
    c = consts.reshape(-1, 4)
    fb = 0.5 * (x1 - 1.0)
    fa, fc = x0 + fb + 1.0, fb * fb
    prev2, prev, r1 = 0.0, scale, [scale * c[0, 3]]
    for i in range(1, n + 1):
        v = (c[i, 0] * fa - c[i, 1] * fb) * prev - (c[i, 2] * fc) * prev2
        r1.append(v * c[i, 3])
        prev2, prev = prev, v
    fb = -1.0
    fa, fc = x1 + fb + 1.0, fb * fb
    c1, e = c[n + 1:], 0
    for r in range(n + 1):
        prev2, prev = 0.0, r1[r]
        out[slots[e]] = prev * c1[e, 3]
        e += 1
        for i in range(1, n - r + 1):
            v = (c1[e, 0] * fa - c1[e, 1] * fb) * prev - (c1[e, 2] * fc) * prev2
            out[slots[e]] = v * c1[e, 3]
            prev2, prev = prev, v
            e += 1
    return out


def _dubiner1_point(x0, consts, n, scale):
    """csrc/dubiner1.cuh's per-point recurrence in numpy, reading the packed
    constants as the kernels do; level i is member i."""
    out = np.zeros((n + 1,) + np.shape(x0))
    out[0] = scale if n == 0 else scale * consts[3]
    if n == 0:
        return out
    c = consts.reshape(-1, 4)
    fb = 0.5 * (-1.0 + -1.0)
    fa, fc = x0 + fb + 1.0, fb * fb
    prev2, prev = 0.0, scale
    for i in range(1, n + 1):
        v = (c[i, 0] * fa - c[i, 1] * fb) * prev - (c[i, 2] * fc) * prev2
        out[i] = v * c[i, 3]
        prev2, prev = prev, v
    return out


@pytest.mark.parametrize("variant", [None, "bubble", "dual"])
@pytest.mark.parametrize("degree", [0, 1, 4, 10])
def test_packed_constants_run_the_variant_recurrences(variant, degree):
    """The kernels' recurrence on pack_stages' constants is
    dubiner_tabulate's raw recurrence (no C0 recovery), for every variant."""
    consts, slots = pack_stages(degree, variant)
    ref = PTS @ np.array([[2.0, 0.0], [0.0, 2.0]]).T - 1.0
    got = _dubiner2_point(ref[:, 0], ref[:, 1], consts, slots, degree, 1.25)
    want = texp.dubiner_tabulate(2, degree, [ref[:, 0], ref[:, 1]], 1.25, variant=variant,
                                 raw=True)
    assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()


def test_wrapper_rejects_bad_inputs():
    rec = _recurrence(ExpansionSet(tcl.ufc_simplex(2)), 3)
    with pytest.raises(TypeError):
        rec(torch.as_tensor(PTS, dtype=torch.float32))
    with pytest.raises(ValueError):
        rec(torch.as_tensor(PTS[:, :1]).contiguous())
    with pytest.raises(ValueError):
        rec(torch.as_tensor(np.asfortranarray(PTS)).T.contiguous().T)
    with pytest.raises(NotImplementedError, match="sd = 1, 2, 3"):
        DubinerRecurrence(4, 2, 1.0, (np.eye(4), np.zeros(4)), device="cpu")
    with pytest.raises(ValueError, match="negative"):
        DubinerRecurrence(2, -1, 1.0, (np.eye(2), np.zeros(2)), device="cpu")
    # the first degrees past the unrolled instantiations (refused before the
    # generic kernel) compute, and match fiat_tpu's recurrence
    for sd in (2, 3):
        degree = UNROLLED_DEGREE[sd] + 1
        es, jes = ExpansionSet(tcl.ufc_simplex(sd)), JExpansionSet(jcl.ufc_simplex(sd))
        pts = np.random.default_rng(sd).random((50, sd)) / sd
        gen = DubinerRecurrence(sd, degree, es.get_scale(degree), es.affine_mappings[0],
                                device="cpu")
        assert gen.generic and gen.nexp == math.comb(degree + sd, sd)
        want = np.asarray(jes._tabulate_on_cell(degree, pts)[(0,) * sd])
        got = gen(torch.as_tensor(pts)).numpy()
        assert np.abs(got - want).max() <= 1e-13 * np.abs(want).max()
