"""Linear functionals (dual-basis nodes) in struct-of-arrays form.

Counterpart of ``fiat_tpu/core/functionals.py`` (the ``Functional`` base
and the point evaluations the nodal elements use).  Every functional is
stored as five flat arrays

    ell(f) = sum_k  weights[k] * (D^{alphas[k]} f)_{comps[k]} (points[pt_ids[k]])

and the Riesz map (the rows of the generalized Vandermonde system) is one
expansion tabulation over the union of all points followed by a segment-sum
per derivative multi-index (``riesz_representers``).  Moment functionals,
which need quadrature, are not ported yet.
"""

import numpy as np


def flat_component(comp, shape):
    """C-order flat index of component tuple ``comp`` in ``shape``."""
    if not shape:
        return 0
    if not isinstance(comp, (tuple, list, np.ndarray)):
        comp = (comp,)
    return int(np.ravel_multi_index(tuple(comp), shape))


class Functional:
    """A discrete linear functional over points, derivative multi-indices,
    components and weights (see the module docstring for the encoding)."""

    def __init__(self, ref_el, target_shape, functional_type, points,
                 pt_ids=None, weights=None, comps=None, alphas=None):
        self.ref_el = ref_el
        self.target_shape = tuple(target_shape) if target_shape else ()
        self.functional_type = functional_type
        points = np.asarray(points, dtype=float)
        if points.ndim != 2:
            points = points.reshape(max(len(points), 1), -1)
        self.points = points
        sd = points.shape[1]
        weights = np.zeros(0) if weights is None else np.asarray(weights, float).ravel()
        n = weights.shape[0]
        self.weights = weights
        self.pt_ids = (np.zeros(n, np.intp) if pt_ids is None
                       else np.asarray(pt_ids, np.intp).ravel())
        self.comps = (np.zeros(n, np.intp) if comps is None
                      else np.asarray(comps, np.intp).ravel())
        self.alphas = (np.zeros((n, sd), np.intp) if alphas is None
                       else np.asarray(alphas, np.intp).reshape(n, sd))

    def get_reference_element(self):
        return self.ref_el

    def _unflat(self, c):
        if not self.target_shape:
            return ()
        return tuple(int(i) for i in np.unravel_index(c, self.target_shape))

    @property
    def pt_dict(self):
        """{point: [(weight, component)]} of the value terms."""
        d = {}
        orders = self.alphas.sum(axis=1)
        for k in np.flatnonzero(orders == 0):
            pt = tuple(self.points[self.pt_ids[k]].tolist())
            d.setdefault(pt, []).append((self.weights[k], self._unflat(self.comps[k])))
        return d

    def get_point_dict(self):
        return self.pt_dict


def _segment_sum(out, rows, values):
    """out[rows[k]] += values[k] with duplicate rows reduced first."""
    order = np.argsort(rows, kind="stable")
    r = rows[order]
    v = values[order]
    starts = np.flatnonzero(np.r_[True, r[1:] != r[:-1]])
    out[r[starts]] += np.add.reduceat(v, starts, axis=0)


def riesz_representers(nodes, poly_set, shape=None):
    """Batched Riesz map of a list of functionals:
    array (len(nodes), *shape, num_exp), shape defaulting to the first
    functional's target_shape."""
    es = poly_set.get_expansion_set()
    ed = poly_set.get_embedded_degree()
    num_exp = es.get_num_members(ed)
    tshape = nodes[0].target_shape if shape is None else tuple(shape)
    ncomp = int(np.prod(tshape, dtype=int)) if tshape else 1
    out = np.zeros((len(nodes) * ncomp, num_exp))

    offs = np.cumsum([0] + [n.points.shape[0] for n in nodes])
    allpts = np.concatenate([n.points for n in nodes], axis=0)
    gpt = np.concatenate([n.pt_ids + o for n, o in zip(nodes, offs)])
    gw = np.concatenate([n.weights for n in nodes])
    gcomp = np.concatenate([n.comps for n in nodes])
    galpha = np.concatenate([n.alphas for n in nodes], axis=0)
    gnode = np.concatenate([np.full(n.weights.shape[0], i, np.intp)
                            for i, n in enumerate(nodes)])
    grow = gnode * ncomp + gcomp
    orders = galpha.sum(axis=1)

    value = np.flatnonzero(orders == 0)
    if value.size:
        upts, inv = np.unique(allpts[gpt[value]], axis=0, return_inverse=True)
        tab = es.tabulate(ed, upts)                       # (num_exp, npts)
        _segment_sum(out, grow[value], gw[value, None] * tab.T[inv.ravel()])

    deriv = np.flatnonzero(orders > 0)
    if deriv.size:
        upts, inv = np.unique(allpts[gpt[deriv]], axis=0, return_inverse=True)
        inv = inv.ravel()
        jets = es._tabulate(ed, upts, order=int(orders[deriv].max()))
        ualphas, ai = np.unique(galpha[deriv], axis=0, return_inverse=True)
        ai = ai.ravel()
        for a, alpha in enumerate(map(tuple, ualphas)):
            sel = deriv[ai == a]
            _segment_sum(out, grow[sel], gw[sel, None] * jets[alpha].T[inv[ai == a]])

    return out.reshape((len(nodes),) + tshape + (num_exp,))


class PointEvaluation(Functional):
    """f -> f(x)."""

    def __init__(self, ref_el, x):
        super().__init__(ref_el, (), "PointEval", [tuple(x)], weights=[1.0])

    def __call__(self, fn):
        return fn(tuple(self.points[0]))
