"""``ops.tabulate.ElementTabulator``: one element's tables on the f64
kernel engine (K1 + K2 on the card, their plain versions on the CPU),
against fiat_tpu's ``ElementTabulator`` and the host tables.

* ``device="cpu"``: Lagrange 4 on the triangle at order 1
  (tests/test_device_ops.py), Lagrange 8 on the tetrahedron at order 1
  (tests/test_symbolic.py's BASELINE config 2), the interval, RT and N1,
  order 2: within RTOL_FIAT_TPU of max(1, max |table|) per alpha of
  fiat_tpu's tables and within HOST_ATOL of the host's.
* Degrees past K1's unrolled instantiations (triangle 16, tet 11) and DPC
  on the quadrilateral and hexahedron (its basis on the embedded simplex),
  degrees 1-3, against fiat_tpu and the host.
* Every refusal by name (``NotImplementedError``): a macro element (where
  fiat_tpu fails too, each held to its own error), an element without a
  nodal expansion basis, any other element on a cell past the interval,
  triangle and tetrahedron, a basis wider than K2 takes (tet 15).
* On a card (marker ``cuda``, skipped without one): one K1 and one K2
  launch a call, the tables against the plain engine's.

The fiat_tpu imports are made inside the tests that compare with it, so
the card machine runs the ``cuda`` case without JAX."""

import numpy as np
import pytest
import torch

import fiat_tpu_torch as ft
from fiat_tpu_torch.core import cells as tcl
from fiat_tpu_torch.ops.tabulate import ElementTabulator

#: fiat_tpu's ElementTabulator (an Ozaki f64 product) against the port's,
#: of max(1, max |table|) per alpha
RTOL_FIAT_TPU = 1e-11
#: either engine against the host tables, max abs (BASELINE.json's bar)
HOST_ATOL = 1e-10


def _build(module, spec):
    """The element of ``spec`` = (family, cell, degree) in either package."""
    family, cell, degree = spec
    cells = module.cells if hasattr(module, "cells") else module
    ref = {"I": cells.ufc_simplex(1), "T": cells.ufc_simplex(2),
           "S": cells.ufc_simplex(3), "Q": cells.UFCQuadrilateral(),
           "H": cells.UFCHexahedron()}[cell]
    return getattr(module, family)(ref, degree)


def _points(sd, n, seed):
    pts = np.random.default_rng(seed).random((n, sd))
    return pts / (sd + 0.5)


#: (family, cell, degree, order): where fiat_tpu's ElementTabulator computes
PARITY = [("Lagrange", "T", 4, 1), ("Lagrange", "S", 8, 1), ("Legendre", "I", 4, 2),
          ("IntegratedLegendre", "I", 5, 1), ("RaviartThomas", "T", 3, 2),
          ("Nedelec", "S", 2, 1), ("BrezziDouglasMarini", "T", 2, 2)]


@pytest.mark.parametrize("family,cell,degree,order", PARITY,
                         ids=[f"{f}-{c}-{d}-o{o}" for f, c, d, o in PARITY])
def test_matches_fiat_tpu_and_host(family, cell, degree, order):
    import jax.numpy as jnp
    import fiat_tpu.elements as jfe
    from fiat_tpu.core import cells as jcl
    from fiat_tpu.ops.tabulate import ElementTabulator as JaxElementTabulator
    t = _build(ft, (family, cell, degree))
    j = _build(type("m", (), {"cells": jcl, family: getattr(jfe, family)}), (family, cell, degree))
    sd = t.get_reference_element().get_spatial_dimension()
    pts = _points(sd, 57, degree)
    tab = ElementTabulator(t, order, device="cpu", tile=4096, matmul="ozaki")
    mine = tab(pts)
    ref = JaxElementTabulator(j, order)(jnp.asarray(pts))
    host = t.tabulate(order, pts)
    assert set(mine) == set(ref) == set(host)
    for alpha in host:
        x, y = mine[alpha].numpy(), np.asarray(ref[alpha])
        assert x.shape == y.shape == host[alpha].shape
        assert np.abs(x - y).max() <= RTOL_FIAT_TPU * max(1.0, np.abs(y).max()), alpha
        assert np.abs(x - host[alpha]).max() <= HOST_ATOL, alpha
        assert np.abs(y - host[alpha]).max() <= HOST_ATOL, alpha
    # the plain versions add no launch
    assert tab.recurrence.launches == 0 and tab.matmul.launches == 0


@pytest.mark.parametrize("family,degree", [("Lagrange", 3), ("DiscontinuousLagrange", 4),
                                           ("GaussLobattoLegendre", 5)])
def test_interval_nodal_bases_against_host(family, degree):
    """The interval's barycentric nodal bases: fiat_tpu's ElementTabulator
    cannot trace them (a numpy basis); the port's engine takes them through
    its change of basis."""
    el = getattr(ft, family)(tcl.ufc_simplex(1), degree)
    pts = _points(1, 41, degree)
    mine = ElementTabulator(el, 2, device="cpu")(pts)
    host = el.tabulate(2, pts)
    for alpha in host:
        assert np.abs(mine[alpha].numpy() - host[alpha]).max() <= HOST_ATOL, alpha


MACRO = {"HCT": lambda m, T, S: m.HsiehCloughTocher(T, 3),
         "P2-alfeld": lambda m, T, S: m.Lagrange(T, 2, variant="alfeld"),
         "P2-worsey-farin": lambda m, T, S: m.Lagrange(S, 2, variant="worsey-farin")}


@pytest.mark.parametrize("name", list(MACRO))
def test_macro_element_refused_where_fiat_tpu_fails(name):
    """fiat_tpu's ElementTabulator tabulates subcell 0's basis against the
    whole complex's coefficients and fails in its product; the port names
    the case."""
    import jax.numpy as jnp
    import fiat_tpu.elements as jfe
    from fiat_tpu.core import cells as jcl
    from fiat_tpu.ops.tabulate import ElementTabulator as JaxElementTabulator
    t = MACRO[name](ft, tcl.ufc_simplex(2), tcl.ufc_simplex(3))
    j = MACRO[name](jfe, jcl.ufc_simplex(2), jcl.ufc_simplex(3))
    pts = _points(t.get_reference_element().get_spatial_dimension(), 7, 0)
    with pytest.raises(ValueError, match="dimension_numbers"):
        JaxElementTabulator(j, 1)(jnp.asarray(pts))
    with pytest.raises(NotImplementedError, match="ElementTabulator: .* is a macro element"):
        ElementTabulator(t, 1, device="cpu")


@pytest.mark.parametrize("spec,match", [
    (("Bernstein", "T", 3), r"ElementTabulator: \w+ has no nodal expansion basis"),
    (("HDivTrace", "T", 2), r"ElementTabulator: \w+ has no nodal expansion basis"),
    (("Serendipity", "Q", 2), r"ElementTabulator: \w+ on UFCQuadrilateral; the kernel engine "
                              "covers"),
    (("Lagrange", "S", 15), None),
], ids=["bernstein", "trace", "serendipity-quad", "tet-15"])
def test_refusals_by_name(spec, match):
    """The cases ElementTabulator refuses, by name; tet degree 15 (816
    members, past the 792 K2 keeps resident) is refused no more: K2 streams
    Phi (``tests/test_torch_wide.py`` holds it to fiat_tpu)."""
    if match is None:
        assert ElementTabulator(_build(ft, spec), 1, device="cpu").matmul.mode == "streamed"
        return
    with pytest.raises(NotImplementedError, match=match):
        ElementTabulator(_build(ft, spec), 1, device="cpu")


def _against_fiat_tpu(spec, order, npts, seed, rtol_host):
    """The port's ElementTabulator (plain versions) and fiat_tpu's on the same
    points: within RTOL_FIAT_TPU of max(1, max |table|) per alpha of each
    other, and both within ``rtol_host`` of it of the host's."""
    import jax.numpy as jnp
    import fiat_tpu.elements as jfe
    from fiat_tpu.core import cells as jcl
    from fiat_tpu.ops.tabulate import ElementTabulator as JaxElementTabulator
    t = _build(ft, spec)
    j = _build(type("m", (), {"cells": jcl, spec[0]: getattr(jfe, spec[0])}), spec)
    sd = t.get_reference_element().get_spatial_dimension()
    pts = _points(sd, npts, seed)
    tab = ElementTabulator(t, order, device="cpu")
    mine = tab(pts)
    ref = JaxElementTabulator(j, order)(jnp.asarray(pts))
    host = t.tabulate(order, pts)
    assert set(mine) == set(ref) == set(host)
    for alpha in host:
        x, y, h = mine[alpha].numpy(), np.asarray(ref[alpha]), host[alpha]
        big = max(1.0, np.abs(h).max())
        assert x.shape == y.shape == h.shape
        assert np.abs(x - y).max() <= RTOL_FIAT_TPU * big, alpha
        assert np.abs(x - h).max() <= rtol_host * big, alpha
        assert np.abs(y - h).max() <= rtol_host * big, alpha
    assert tab.recurrence.launches == 0 and tab.matmul.launches == 0
    return tab


@pytest.mark.parametrize("spec", [("Lagrange", "T", 16), ("Lagrange", "S", 11)],
                         ids=["tri-16", "tet-11"])
def test_past_the_unrolled_degrees_matches_fiat_tpu(spec):
    """The degrees the port refused before its generic kernels (triangle
    16, tet 11: fiat_tpu's XLA recurrence takes them, 2.8e-10 / 6.8e-12
    from host) against fiat_tpu and the host, relative to max(1, max
    |table|)."""
    tab = _against_fiat_tpu(spec, 1, 41, spec[2], RTOL_FIAT_TPU)
    assert tab.recurrence.generic


@pytest.mark.parametrize("cell", ["Q", "H"])
@pytest.mark.parametrize("degree", [1, 2, 3])
def test_dpc_matches_fiat_tpu_and_host(cell, degree):
    """DPC on the quadrilateral and the hexahedron: its nodal basis is a
    Dubiner set on the embedded simplex, which the one-element engine runs
    (K1 at the cell's points), as fiat_tpu's ElementTabulator does."""
    tab = _against_fiat_tpu(("DPC", cell, degree), 1, 37, degree, RTOL_FIAT_TPU)
    assert tab.engine.recurrence.sd == (2 if cell == "Q" else 3)


def test_keywords():
    el = ft.Lagrange(tcl.ufc_simplex(2), 2)
    ElementTabulator(el, 1, device="cpu", tile=8, matmul="native", wdtype="bf16",
                     interpret=True)
    with pytest.raises(TypeError, match="unexpected keyword arguments"):
        ElementTabulator(el, 1, device="cpu", tiles=8)


@pytest.mark.cuda
def test_on_the_card_one_launch_each():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for spec, order, seed in ((("Lagrange", "T", 4), 1, 1), (("Lagrange", "S", 8), 1, 2)):
        el = _build(ft, spec)
        sd = el.get_reference_element().get_spatial_dimension()
        pts = _points(sd, 3001, seed)
        tab = ElementTabulator(el, order)
        assert tab.device.type == "cuda"
        got = tab(torch.as_tensor(pts, device=tab.device))
        assert tab.recurrence.launches == 1 and tab.matmul.launches == 1
        plain = ElementTabulator(el, order, device="cpu")(pts)
        host = el.tabulate(order, pts)
        for alpha in host:
            assert np.abs(got[alpha].cpu().numpy() - plain[alpha].numpy()).max() <= 1e-12 * max(
                1.0, np.abs(host[alpha]).max())
            assert np.abs(got[alpha].cpu().numpy() - host[alpha]).max() <= HOST_ATOL
