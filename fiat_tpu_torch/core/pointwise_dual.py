"""Recover a pointwise dual basis for a non-nodal primal basis.

Counterpart of ``fiat_tpu/core/pointwise_dual.py``: invert the tabulation
at a unisolvent point set; each row of the inverse is the term-weight array
of a functional combining point evaluations."""

import numpy as np

from .dualset import DualSet
from .functionals import Functional


def compute_pointwise_dual(el, pts):
    """A DualSet of pointwise-evaluation functionals dual to el's basis
    (exact on the polynomial space; finite-difference-like outside it)."""
    nbf = el.space_dimension()
    T = el.ref_el
    sd = T.get_spatial_dimension()
    shape = el.value_shape()
    ncomp = int(np.prod(shape, dtype=int)) if shape else 1
    pts = np.asarray(pts)
    assert pts.shape == (nbf // ncomp, sd)

    V = el.tabulate(0, pts)[(0,) * sd]
    # rows of the inverse: dense weights W[dof, *comp, point]
    W = np.linalg.inv(V.reshape(nbf, -1).T).reshape(V.shape)
    Wf = np.moveaxis(W.reshape(nbf, ncomp, -1), 1, 2)     # (nbf, npts, ncomp)

    nds = []
    for row in Wf:
        keep = np.abs(row) > 1e-12                        # (npts, ncomp) mask
        used = np.flatnonzero(keep.any(axis=1))
        remap = np.zeros(row.shape[0], np.intp)
        remap[used] = np.arange(used.size)
        pt_ids, comps = np.nonzero(keep)
        nds.append(Functional(T, shape, "node", pts[used],
                              pt_ids=remap[pt_ids],
                              weights=row[pt_ids, comps],
                              comps=comps))
    return DualSet(nds, T, el.entity_dofs())
