"""The port's DirectSerendipity and sympy2array (``fiat_tpu_torch.symbolic``)
against ``fiat_tpu.symbolic`` on the CPU, as tests/test_direct_serendipity.py
holds fiat_tpu's: the Kronecker property at the nodes of its distorted
quadrilateral (degrees 1-4), entity dofs and dimensions, tensor vertices
and points (``chip_smoke.QuadMapping``, the geometry phase 27 drives on
the card) against fiat_tpu's ``jax.jit`` evaluation at 1e-12 of
max(1, max |table|) (degrees 1-3; degree 4 against fiat_tpu's numpy
evaluation, which spares a third sympy-heavy trace), the numpy path
bit for bit with fiat_tpu's at every degree, a meta-device
geometry that stays there, and ``evaluate_sympy`` on numpy and tensor
bindings, ``Piecewise`` included.  fiat_tpu's three
``test_parity_with_reference_construction`` cases import FIAT; the port
is held to fiat_tpu only."""

import sys
from functools import lru_cache
from pathlib import Path

import numpy as np
import pytest
import sympy
import torch

from fiat_tpu_torch.core import cells as tcl
from fiat_tpu_torch.symbolic import DirectSerendipity as TDirectSerendipity
from fiat_tpu_torch.symbolic import evaluate_sympy as t_evaluate_sympy
from fiat_tpu_torch.symbolic.point_set import PointSet, UnknownPointSet

import jax
import jax.numpy as jnp
from fiat_tpu.core import cells as jcl
from fiat_tpu.symbolic import DirectSerendipity as JDirectSerendipity
from fiat_tpu.symbolic import evaluate_sympy as j_evaluate_sympy
from fiat_tpu.symbolic.point_set import PointSet as JPointSet
from fiat_tpu.symbolic.point_set import UnknownPointSet as JUnknownPointSet

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE))
sys.path.insert(0, str(HERE.parent))
import chip_smoke  # noqa: E402
import test_direct_serendipity as tds  # noqa: E402

#: the tensor path vs fiat_tpu's jit evaluation or the host, of max(1, max |table|)
RTOL = 1e-12


@lru_cache(maxsize=None)
def _port(degree):
    return TDirectSerendipity(tcl.ufc_cell("quadrilateral"), degree)


@lru_cache(maxsize=None)
def _fiat_tpu(degree):
    return JDirectSerendipity(jcl.ufc_cell("quadrilateral"), degree)


def _rel(got, want):
    got = got.numpy() if torch.is_tensor(got) else np.asarray(got)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


def test_vertices_are_test_direct_serendipitys():
    assert np.array_equal(np.asarray(chip_smoke.DS_VERTS), tds.VERTS)


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_kronecker(degree):
    cell = tcl.ufc_cell("quadrilateral")
    element = _port(degree)
    pts = PointSet(tds.ref_nodes(cell, degree))
    vals = element.basis_evaluation(0, pts, coordinate_mapping=chip_smoke.QuadMapping(
        tds.VERTS))[(0, 0)]
    assert isinstance(vals, np.ndarray) and vals.shape[0] == element.space_dimension()
    assert np.allclose(vals, np.eye(*vals.shape), atol=1e-10)


@pytest.mark.parametrize("degree", [1, 2, 3, 4])
def test_entity_dofs_and_dimension(degree):
    t, j = _port(degree), _fiat_tpu(degree)
    assert t.space_dimension() == j.space_dimension() == {1: 4, 2: 8, 3: 12, 4: 17}[degree]
    assert t.entity_dofs() == j.entity_dofs()
    assert t.mapping == j.mapping == "physical"
    assert t.index_shape == j.index_shape and t.value_shape == j.value_shape == ()


@pytest.mark.parametrize("degree", [1, 2, 3])
def test_tensor_evaluation_matches_fiat_tpu_jit(degree):
    """Tensor vertices and points (CPU) against fiat_tpu under jax.jit with
    traced vertices and points, order 1; numpy against numpy bit for bit."""
    pts = np.random.default_rng(degree).random((40, 2))
    jel = _fiat_tpu(degree)
    jcell = jcl.ufc_cell("quadrilateral")

    @jax.jit
    def traced(verts, p):
        mapping = tds.QuadMapping(jcell, np.empty((4, 2)))
        mapping.verts = verts
        return jel.basis_evaluation(1, JUnknownPointSet(p), coordinate_mapping=mapping)

    want = {a: np.asarray(v) for a, v in traced(jnp.asarray(tds.VERTS), jnp.asarray(pts)).items()}
    got = _port(degree).basis_evaluation(1, UnknownPointSet(pts, device="cpu"),
                                         coordinate_mapping=chip_smoke.QuadMapping(
                                             torch.as_tensor(tds.VERTS)))
    assert set(got) == set(want)
    for alpha, w in want.items():
        assert torch.is_tensor(got[alpha]) and got[alpha].dtype == torch.float64
        assert tuple(got[alpha].shape) == w.shape
        assert _rel(got[alpha], w) <= RTOL, alpha
    host_t = _port(degree).basis_evaluation(1, PointSet(pts), coordinate_mapping=chip_smoke.
                                            QuadMapping(tds.VERTS))
    host_j = jel.basis_evaluation(1, JPointSet(pts), coordinate_mapping=tds.QuadMapping(
        jcell, tds.VERTS))
    for alpha, w in host_j.items():
        assert np.array_equal(host_t[alpha], np.asarray(w)), alpha


def test_degree_4_tensor_evaluation_matches_host():
    """Degree 4 (its own interior bubble) against fiat_tpu's numpy
    evaluation, order 1: the port's numpy path bit for bit, its tensor
    path at RTOL."""
    pts = np.random.default_rng(4).random((40, 2))
    el = _port(4)
    want = _fiat_tpu(4).basis_evaluation(1, JPointSet(pts), coordinate_mapping=tds.QuadMapping(
        jcl.ufc_cell("quadrilateral"), tds.VERTS))
    host = el.basis_evaluation(1, PointSet(pts), coordinate_mapping=chip_smoke.QuadMapping(
        tds.VERTS))
    got = el.basis_evaluation(1, UnknownPointSet(pts, device="cpu"),
                              coordinate_mapping=chip_smoke.QuadMapping(torch.as_tensor(tds.VERTS)))
    assert set(host) == set(got) == set(want)
    for alpha, w in want.items():
        w = np.asarray(w)
        assert np.array_equal(host[alpha], w), alpha
        assert torch.is_tensor(got[alpha]) and tuple(got[alpha].shape) == w.shape
        assert _rel(got[alpha], w) <= RTOL, alpha


@pytest.mark.parametrize("degree", [1, 2])
def test_tensor_geometry_stays_on_its_device(degree):
    """Vertices and points on the meta device (no data; numpy cannot take
    them): every table comes back a meta tensor of the right shape."""
    el = _port(degree)
    ps = UnknownPointSet(torch.empty((7, 2), dtype=torch.float64), device="meta")
    tables = el.basis_evaluation(1, ps, coordinate_mapping=chip_smoke.QuadMapping(
        torch.as_tensor(tds.VERTS, device="meta")))
    for table in tables.values():
        assert table.device.type == "meta" and tuple(table.shape) == (el.space_dimension(), 7)


X, Y = sympy.symbols("x y")
EXPRESSIONS = {
    "polynomial": X ** 3 - 2 * X * Y + sympy.Rational(1, 3),
    "rational": (X + 1) / (Y ** 2 + 2) - sympy.Integer(2) * (X + 1) ** -2,
    "abs_float_pow": sympy.Abs(X - Y) * sympy.Float(0.25) + (X + 2) ** sympy.Rational(1, 2),
    "piecewise": sympy.Piecewise((X ** 2, X < 0.5), (Y - X, sympy.Ge(Y, 0.7)), (1 - X, True)),
    "piecewise_eq": sympy.Piecewise((X, sympy.Eq(X, Y)), (X * Y, sympy.Ne(X, 0)), (2, True)),
    "constant": sympy.pi * 2,
}


@pytest.mark.parametrize("name", sorted(EXPRESSIONS))
def test_evaluate_sympy(name):
    """numpy bindings bit for bit with fiat_tpu; tensor bindings (points as
    tensors, or a tensor beside a float) equal to numpy's to 1e-15 (torch's
    and numpy's powers may differ in the last bit); on the meta device the
    value stays there."""
    expr = EXPRESSIONS[name]
    x = np.random.default_rng(5).random(50)
    x[:5] = [0.5, 0.25, 0.75, 0.0, 1.0]
    y = np.random.default_rng(6).random(50)
    y[:5] = [0.5, 0.25, 0.7, 0.3, 0.9]
    want = j_evaluate_sympy(expr, {X: x, Y: y})
    got = t_evaluate_sympy(expr, {X: x, Y: y})
    assert np.array_equal(np.asarray(got), np.asarray(want))
    tensor = t_evaluate_sympy(expr, {X: torch.as_tensor(x), Y: torch.as_tensor(y)})
    if name == "constant":
        assert tensor == want
        return
    assert torch.is_tensor(tensor) and tensor.dtype == torch.float64
    assert _rel(tensor, np.broadcast_to(want, x.shape)) <= 1e-15
    mixed = t_evaluate_sympy(expr, {X: torch.as_tensor(x), Y: 0.6})
    assert _rel(np.broadcast_to(mixed.numpy(), x.shape),
                np.broadcast_to(j_evaluate_sympy(expr, {X: x, Y: 0.6}), x.shape)) <= 1e-15
    meta = t_evaluate_sympy(expr, {X: torch.as_tensor(x, device="meta"),
                                   Y: torch.as_tensor(y, device="meta")})
    assert meta.device.type == "meta" and tuple(meta.shape) in ((50,), ())
