"""Linear functionals (dual-basis nodes) in struct-of-arrays form.

Counterpart of ``fiat_tpu/core/functionals.py`` (the functionals the
``full_zoo`` elements use).  Every functional is stored as five flat arrays

    ell(f) = sum_k  weights[k] * (D^{alphas[k]} f)_{comps[k]} (points[pt_ids[k]])

    points   (npts, space_dim)     evaluation points
    pt_ids   (nterms,)             point index per term
    alphas   (nterms, space_dim)   derivative multi-index per term (zeros = value)
    comps    (nterms,)             flat C-order component index into target_shape
    weights  (nterms,)             term weights

and the Riesz map (the rows of the generalized Vandermonde system) is one
expansion tabulation over the union of all points followed by a segment-sum
per derivative multi-index (``riesz_representers``), for scalar and
vector/tensor target shapes alike.  Point evaluations of values and
derivatives, integral moments of values and derivatives (pushed onto
facets by ``quadrature.FacetQuadratureRule``), the bidirectional inner
products v^T u w of tensor fields, pointwise and as moments, pointwise
divergence, moments of a field's divergence (vector and tensor), the
moments of normal and tangential traces on facets and edges, and the
Legendre-weighted edge moments (directional, normal, tangential and the
bidirectional ones): every functional class of fiat_tpu, with its names
and arguments.
"""

import numpy as np

from . import quadrature, quadrature_schemes


def flat_component(comp, shape):
    """C-order flat index of component tuple ``comp`` in ``shape``."""
    if not shape:
        return 0
    if not isinstance(comp, (tuple, list, np.ndarray)):
        comp = (comp,)
    return int(np.ravel_multi_index(tuple(comp), shape))


def directional_alphas(S, space_dim):
    """Collapse a rank-k direction tensor S (product of k directions) into
    derivative multi-indices: returns (alphas (m, space_dim), weights (m,)) with
    sum_alpha w_alpha D^alpha == sum_{i1..ik} S[i1..ik] d_{i1}..d_{ik}."""
    S = np.asarray(S, dtype=float)
    tau = {}
    for index in np.ndindex(S.shape):
        alpha = tuple(np.bincount(index, minlength=space_dim))
        tau[alpha] = tau.get(alpha, 0.0) + S[index]
    alphas = np.array(sorted(tau), dtype=np.intp).reshape(len(tau), space_dim)
    weights = np.array([tau[tuple(a)] for a in alphas])
    return alphas, weights


def _derivative_term_arrays(alphas, W, comps=None):
    """Term arrays for derivative "alpha slots":
    ell(f) = sum_q sum_a W[q, a] (D^{alphas[a]} f)_{comps[a]}(x_q)."""
    W = np.asarray(W, dtype=float)
    alphas = np.asarray(alphas, np.intp)
    npts, nalpha = W.shape
    slot_comps = (np.zeros(nalpha, np.intp) if comps is None
                  else np.asarray(comps, np.intp))
    return dict(pt_ids=np.repeat(np.arange(npts), nalpha),
                weights=W.ravel(),
                comps=np.tile(slot_comps, npts),
                alphas=np.tile(alphas, (npts, 1)))


class Functional:
    """A discrete linear functional over points, derivative multi-indices,
    components and weights (see module docstring for the term encoding)."""

    def __init__(self, ref_el, target_shape, functional_type, points,
                 pt_ids=None, weights=None, comps=None, alphas=None):
        self.ref_el = ref_el
        self.target_shape = tuple(target_shape) if target_shape else ()
        self.functional_type = functional_type
        points = np.asarray(points, dtype=float)
        if points.ndim != 2:
            points = points.reshape(max(len(points), 1), -1)
        self.points = points
        space_dim = points.shape[1]
        weights = np.zeros(0) if weights is None else np.asarray(weights, float).ravel()
        n = weights.shape[0]
        self.weights = weights
        self.pt_ids = (np.zeros(n, np.intp) if pt_ids is None
                       else np.asarray(pt_ids, np.intp).ravel())
        self.comps = (np.zeros(n, np.intp) if comps is None
                      else np.asarray(comps, np.intp).ravel())
        self.alphas = (np.zeros((n, space_dim), np.intp) if alphas is None
                       else np.asarray(alphas, np.intp).reshape(n, space_dim))

    # -- array-level builders ------------------------------------------------

    @classmethod
    def at_points(cls, ref_el, shape, name, points, weights, comp=()):
        """One value term per point, all against the same component."""
        weights = np.asarray(weights, float).ravel()
        n = weights.shape[0]
        c = flat_component(comp, shape)
        return cls(ref_el, shape, name, points, pt_ids=np.arange(n),
                   weights=weights, comps=np.full(n, c, np.intp))

    @classmethod
    def from_weights(cls, ref_el, shape, name, points, W):
        """Dense value terms: ell(f) = sum_q W[q, *c] f_c(x_q); every
        component slot becomes a term (zeros kept)."""
        W = np.asarray(W, dtype=float)
        npts = W.shape[0]
        ncomp = int(np.prod(shape, dtype=int)) if shape else 1
        return cls(ref_el, shape, name, points,
                   pt_ids=np.repeat(np.arange(npts), ncomp),
                   weights=W.reshape(npts, ncomp).ravel(),
                   comps=np.tile(np.arange(ncomp), npts))

    @classmethod
    def from_derivative_terms(cls, ref_el, shape, name, points, alphas, W, comps=None):
        """Derivative terms from alpha "slots":
        ell(f) = sum_q sum_a W[q, a] (D^{alphas[a]} f)_{comps[a]}(x_q)."""
        return cls(ref_el, shape, name, points, **_derivative_term_arrays(alphas, W, comps))

    # -- queries --------------------------------------------------------------

    @property
    def max_deriv_order(self):
        if self.alphas.shape[0] == 0:
            return 0
        return int(self.alphas.sum(axis=1).max())

    def get_reference_element(self):
        return self.ref_el

    def get_type_tag(self):
        return self.functional_type

    def __call__(self, fn):
        raise NotImplementedError(f"Evaluation not implemented for {type(self)}")

    def evaluate(self, f):
        raise AttributeError("To evaluate the functional just call it on a function.")

    def to_riesz(self, poly_set):
        """Riesz representer against poly_set's expansion set:
        array of shape (*poly_set.value_shape, num_exp)."""
        return riesz_representers([self], poly_set, shape=poly_set.get_shape())[0]

    def tostr(self):
        return self.functional_type

    # -- point-keyed dict views, derived lazily ------------------------------

    def _unflat(self, c):
        if not self.target_shape:
            return ()
        return tuple(int(i) for i in np.unravel_index(c, self.target_shape))

    @property
    def pt_dict(self):
        try:
            return self._pt_dict
        except AttributeError:
            pass
        d = {}
        orders = self.alphas.sum(axis=1)
        for k in np.flatnonzero(orders == 0):
            pt = tuple(self.points[self.pt_ids[k]].tolist())
            d.setdefault(pt, []).append((self.weights[k], self._unflat(self.comps[k])))
        self._pt_dict = d
        return d

    @property
    def deriv_dict(self):
        try:
            return self._deriv_dict
        except AttributeError:
            pass
        d = {}
        orders = self.alphas.sum(axis=1)
        for k in np.flatnonzero(orders > 0):
            pt = tuple(self.points[self.pt_ids[k]].tolist())
            d.setdefault(pt, []).append(
                (self.weights[k], tuple(int(a) for a in self.alphas[k]),
                 self._unflat(self.comps[k])))
        self._deriv_dict = d
        return d

    def get_point_dict(self):
        return self.pt_dict


def _segment_sum(out, rows, values):
    """out[rows[k]] += values[k] with duplicate rows reduced first
    (sort + reduceat segment-sum)."""
    order = np.argsort(rows, kind="stable")
    r = rows[order]
    v = values[order]
    starts = np.flatnonzero(np.r_[True, r[1:] != r[:-1]])
    out[r[starts]] += np.add.reduceat(v, starts, axis=0)


def riesz_representers(nodes, poly_set, shape=None):
    """Batched Riesz map of a list of functionals:
    array (len(nodes), *shape, num_exp), shape defaulting to the first
    functional's target_shape.

    The expansion set is tabulated once over the union of all value points
    and once (as a jet) over the union of all derivative points; the term
    weights are then scattered with one segment-sum per derivative
    multi-index."""
    es = poly_set.get_expansion_set()
    ed = poly_set.get_embedded_degree()
    num_exp = es.get_num_members(ed)
    tshape = nodes[0].target_shape if shape is None else tuple(shape)
    ncomp = int(np.prod(tshape, dtype=int)) if tshape else 1
    out = np.zeros((len(nodes) * ncomp, num_exp))

    # flatten all terms of all nodes into one term table
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
            tab = jets[alpha]
            _segment_sum(out, grow[sel],
                         gw[sel, None] * tab.T[inv[ai == a]])

    return out.reshape((len(nodes),) + tshape + (num_exp,))


class PointEvaluation(Functional):
    """f -> f(x)."""

    def __init__(self, ref_el, x):
        super().__init__(ref_el, (), "PointEval", [tuple(x)],
                         weights=[1.0])

    def __call__(self, fn):
        return fn(tuple(self.points[0]))

    def tostr(self):
        return "u(%s)" % (",".join(map(str, self.points[0])),)


class ComponentPointEvaluation(Functional):
    """f -> f_c(x) for a component c of a vector/tensor field."""

    def __init__(self, ref_el, comp, shp, x):
        if not isinstance(comp, tuple):
            comp = (comp,)
        if len(shp) != len(comp):
            raise ValueError("Component and shape are incompatible")
        if any(i < 0 or i >= n for i, n in zip(comp, shp)):
            raise ValueError("Illegal component")
        self.comp = comp
        super().__init__(ref_el, shp, "ComponentPointEval", [tuple(x)],
                         weights=[1.0], comps=[flat_component(comp, shp)])


class PointNormalEvaluation(Functional):
    """v -> (v . n)(x) on a facet."""

    def __init__(self, ref_el, facet_no, pt):
        self.n = ref_el.compute_normal(facet_no)
        super().__init__(*_vector_point_args(ref_el, self.n, pt, "PointNormalEval"))


class PointScaledNormalEvaluation(Functional):
    """v -> (v . n~)(x), n~ the facet-volume-scaled normal."""

    def __init__(self, ref_el, facet_no, pt):
        n = ref_el.compute_scaled_normal(facet_no)
        super().__init__(*_vector_point_args(ref_el, n, pt, "PointScaledNormalEval"))

    def tostr(self):
        return "(u.n)(%s)" % (",".join(map(str, self.points[0])),)


class PointEdgeTangentEvaluation(Functional):
    """v -> (v . t)(x) on an edge."""

    def __init__(self, ref_el, edge_no, pt):
        self.t = ref_el.compute_edge_tangent(edge_no)
        super().__init__(*_vector_point_args(ref_el, self.t, pt, "PointEdgeTangent"))

    def tostr(self):
        return "(u.t)(%s)" % (",".join(map(str, self.points[0])),)


class PointFaceTangentEvaluation(Functional):
    """v -> (v . t_k)(x) for face tangent t_k."""

    def __init__(self, ref_el, face_no, tno, pt):
        self.t = ref_el.compute_face_tangents(face_no)[tno]
        self.tno = tno
        super().__init__(*_vector_point_args(ref_el, self.t, pt, "PointFaceTangent"))

    def tostr(self):
        return "(u.t%d)(%s)" % (self.tno, ",".join(map(str, self.points[0])))



def _vector_point_args(ref_el, direction, pt, name):
    """(init args) for ``v -> (v . direction)(pt)`` as dense value terms."""
    space_dim = ref_el.get_spatial_dimension()
    W = np.asarray(direction, float).reshape(1, space_dim)
    n = W.shape[1]
    return (ref_el, (space_dim,), name, [tuple(pt)],
            np.zeros(n, np.intp), W.ravel(), np.arange(n))


class PointwiseInnerProductEvaluation(Functional):
    """u (tensor) -> v^T u(p) w, via Frobenius weights w v^T."""

    def __init__(self, ref_el, v, w, pt):
        wvT = np.outer(w, v)
        super().__init__(ref_el, wvT.shape, "PointwiseInnerProductEval",
                         [tuple(pt)],
                         pt_ids=np.zeros(wvT.size, np.intp),
                         weights=wvT.ravel(),
                         comps=np.arange(wvT.size))


class PointDerivative(Functional):
    """f -> D^alpha f(x)."""

    def __init__(self, ref_el, x, alpha):
        self.alpha = tuple(alpha)
        self.order = sum(self.alpha)
        super().__init__(ref_el, (), "PointDeriv", [tuple(x)],
                         weights=[1.0], alphas=[self.alpha])

    def __call__(self, fn):
        import sympy
        x = tuple(self.points[0])
        X = tuple(sympy.Symbol(f"X[{i}]") for i in range(len(x)))
        dvars = tuple(v for v, a in zip(X, self.alpha) for _ in range(a))
        return sympy.lambdify(X, sympy.diff(fn(X), *dvars))(*x)


class PointDirectionalDerivative(Functional):
    """f -> (s . grad f)(x)."""

    def __init__(self, ref_el, s, pt, comp=(), shp=(), nm=None):
        space_dim = ref_el.get_spatial_dimension()
        cf = flat_component(comp, shp)
        super().__init__(ref_el, shp, nm or "PointDirectionalDeriv", [tuple(pt)],
                         pt_ids=np.zeros(space_dim, np.intp),
                         weights=np.asarray(s, float),
                         comps=np.full(space_dim, cf, np.intp),
                         alphas=np.eye(space_dim, dtype=np.intp))


class PointNormalDerivative(PointDirectionalDerivative):
    def __init__(self, ref_el, facet_no, pt, comp=(), shp=()):
        n = ref_el.compute_normal(facet_no)
        super().__init__(ref_el, n, pt, comp=comp, shp=shp, nm="PointNormalDeriv")


class PointTangentialDerivative(PointDirectionalDerivative):
    def __init__(self, ref_el, edge_no, pt, comp=(), shp=()):
        t = ref_el.compute_edge_tangent(edge_no)
        super().__init__(ref_el, t, pt, comp=comp, shp=shp, nm="PointTangentialDeriv")


class PointSecondDerivative(Functional):
    """f -> s1^T (D^2 f)(x) s2."""

    def __init__(self, ref_el, s1, s2, pt, comp=(), shp=(), nm=None):
        space_dim = ref_el.get_spatial_dimension()
        alphas, taus = directional_alphas(np.outer(s1, s2), space_dim)
        cf = flat_component(comp, shp)
        super().__init__(ref_el, shp, nm or "PointSecondDeriv", [tuple(pt)],
                         pt_ids=np.zeros(len(taus), np.intp),
                         weights=taus,
                         comps=np.full(len(taus), cf, np.intp),
                         alphas=alphas)


class PointNormalSecondDerivative(PointSecondDerivative):
    def __init__(self, ref_el, facet_no, pt, comp=(), shp=()):
        n = ref_el.compute_normal(facet_no)
        super().__init__(ref_el, n, n, pt, comp=comp, shp=shp,
                         nm="PointNormalSecondDeriv")


class PointTangentialSecondDerivative(PointSecondDerivative):
    def __init__(self, ref_el, edge_no, pt, comp=(), shp=()):
        t = ref_el.compute_edge_tangent(edge_no)
        super().__init__(ref_el, t, t, pt, comp=comp, shp=shp,
                         nm="PointTangentialSecondDeriv")


class PointDivergence(Functional):
    """v -> (div v)(x)."""

    def __init__(self, ref_el, x):
        space_dim = ref_el.get_spatial_dimension()
        super().__init__(ref_el, (len(x),), "PointDiv", [tuple(x)],
                         pt_ids=np.zeros(space_dim, np.intp),
                         weights=np.ones(space_dim),
                         comps=np.arange(space_dim),
                         alphas=np.eye(space_dim, dtype=np.intp))


class IntegralMoment(Functional):
    """f -> int f_c q  against a tabulated density q (rule Q)."""

    def __init__(self, ref_el, Q, f_at_qpts, comp=tuple(), shp=tuple()):
        self.Q = Q
        self.f_at_qpts = f_at_qpts
        self.comp = comp
        qwts = np.multiply(f_at_qpts, Q.get_weights())
        pts = Q.get_points()
        cf = flat_component(comp, shp)
        super().__init__(ref_el, shp, "IntegralMoment", pts,
                         pt_ids=np.arange(len(pts)),
                         weights=qwts,
                         comps=np.full(len(pts), cf, np.intp))

    def __call__(self, fn):
        result = np.dot([fn(tuple(p)) for p in self.points], self.weights)
        return result[self.comp] if self.comp else result


class FrobeniusIntegralMoment(Functional):
    """u -> int u : F for a tensor density F tabulated at Q's points."""

    def __init__(self, ref_el, Q, f_at_qpts, nm=None):
        shp = tuple(f_at_qpts.shape[:-1])
        npts = len(Q.get_points())
        if npts != f_at_qpts.shape[-1]:
            raise ValueError("Mismatch in number of quadrature points and values")
        self.Q = Q
        self.comp = slice(None, None)
        self.f_at_qpts = f_at_qpts
        # (npts, *shp) dense weights: every component slot per point
        W = np.moveaxis(np.multiply(f_at_qpts, Q.get_weights()), -1, 0)
        ncomp = int(np.prod(shp, dtype=int))
        super().__init__(ref_el, shp, nm or "FrobeniusIntegralMoment",
                         Q.get_points(),
                         pt_ids=np.repeat(np.arange(npts), ncomp),
                         weights=W.reshape(npts, ncomp).ravel(),
                         comps=np.tile(np.arange(ncomp), npts))


class IntegralMomentOfDerivative(Functional):
    """f -> int (D_s1 ... D_sk f)_c q for directions s1..sk."""

    def __init__(self, ref_el, Q, f_at_qpts, *directions, comp=(), shp=(), nm=""):
        self.Q = Q
        self.f_at_qpts = f_at_qpts
        self.comp = comp
        S = directions[0]
        for d in directions[1:]:
            S = np.outer(S, d)
        space_dim = ref_el.get_spatial_dimension()
        alphas, taus = directional_alphas(S, space_dim)
        qwts = np.multiply(f_at_qpts, Q.get_weights())
        self.weights_by_alpha = {tuple(a): qwts * t for a, t in zip(alphas, taus)}
        cf = flat_component(comp, shp)
        super().__init__(ref_el, shp, nm or "IntegralMomentOfDerivative",
                         Q.get_points(),
                         **_derivative_term_arrays(
                             alphas, np.outer(qwts, taus),
                             comps=np.full(len(taus), cf, np.intp)))


class IntegralMomentOfNormalDerivative(IntegralMomentOfDerivative):
    """f -> int_F (dn f) q over a facet F."""

    def __init__(self, ref_el, facet_no, Q_face, f_at_qpts):
        n = ref_el.compute_normal(facet_no)
        space_dim = ref_el.get_spatial_dimension()
        Q = quadrature.FacetQuadratureRule(ref_el, space_dim - 1, facet_no, Q_face, avg=True)
        super().__init__(ref_el, Q, f_at_qpts, n, nm="IntegralMomentOfNormalDerivative")


class IntegralMomentOfDivergence(Functional):
    """v -> int (div v) q."""

    def __init__(self, ref_el, Q, f_at_qpts):
        self.f_at_qpts = f_at_qpts
        self.Q = Q
        space_dim = ref_el.get_spatial_dimension()
        shp = f_at_qpts.shape[1:-1] + (space_dim,)
        pts = Q.get_points()
        self.dpts = pts
        qwts = np.multiply(f_at_qpts, Q.get_weights())
        # slot a: alpha = e_a, component a (the diagonal of grad)
        super().__init__(ref_el, shp, "IntegralMomentOfDivergence", pts,
                         **_derivative_term_arrays(
                             np.eye(space_dim, dtype=np.intp),
                             np.tile(qwts[:, None], (1, space_dim)),
                             comps=np.arange(space_dim)))


class IntegralMomentOfTensorDivergence(Functional):
    """tau -> int (div tau) . q for tensor fields: sum_ij int d_j tau_ij q_i."""

    def __init__(self, ref_el, Q, f_at_qpts):
        self.f_at_qpts = f_at_qpts
        self.Q = Q
        pts = Q.get_points()
        self.dpts = pts
        space_dim = ref_el.get_spatial_dimension()
        assert f_at_qpts.shape == (space_dim, len(pts))
        qwts = np.multiply(f_at_qpts, Q.get_weights()).T     # (npts, space_dim)
        # slots (i, j): alpha = e_j, component (i, j), weight q_i w
        pairs = np.indices((space_dim, space_dim)).reshape(2, -1).T
        alphas = np.eye(space_dim, dtype=np.intp)[pairs[:, 1]]
        comps = np.ravel_multi_index((pairs[:, 0], pairs[:, 1]), (space_dim, space_dim))
        W = qwts[:, pairs[:, 0]]
        super().__init__(ref_el, (), "IntegralMomentOfDivergence", pts,
                         **_derivative_term_arrays(alphas, W, comps=comps))
        # the target shape is (), but comps address (space_dim, space_dim)
        # slots: the dict views unflatten them against that shape
        self._tensor_shape = (space_dim, space_dim)

    def _unflat(self, c):
        return tuple(int(i) for i in np.unravel_index(c, self._tensor_shape))


class TensorBidirectionalIntegralMoment(FrobeniusIntegralMoment):
    r"""u (tensor) -> \int v^T u(x) w f(x)."""

    def __init__(self, ref_el, v, w, Q, f_at_qpts):
        vwT = np.outer(v, w)
        F_at_qpts = np.multiply(vwT[..., None], f_at_qpts)
        super().__init__(ref_el, Q, F_at_qpts,
                         "TensorBidirectionalMomentInnerProductEvaluation")


def _facet_trace_moment_args(ref_el, Q, P_at_qpts, entity_dim, entity_id,
                             direction, name):
    """(init args) for ``v -> int_F (v . direction) p``: the rule Q lives on
    the reference facet and is pushed onto the named entity."""
    space_dim = ref_el.get_spatial_dimension()
    transform = ref_el.get_entity_transform(entity_dim, entity_id)
    pts = np.asarray(transform(Q.get_points()))
    W = np.outer(np.multiply(P_at_qpts, Q.get_weights()),
                 np.asarray(direction, float))          # (npts, space_dim)
    npts = W.shape[0]
    return (ref_el, (space_dim,), name, pts,
            np.repeat(np.arange(npts), space_dim), W.ravel(),
            np.tile(np.arange(space_dim), npts))


class IntegralMomentOfNormalEvaluation(Functional):
    r"""v -> \int_F (v . n~) p ds (volume-scaled normal)."""

    def __init__(self, ref_el, Q, P_at_qpts, facet):
        space_dim = ref_el.get_spatial_dimension()
        n = ref_el.compute_scaled_normal(facet)
        super().__init__(*_facet_trace_moment_args(
            ref_el, Q, P_at_qpts, space_dim - 1, facet, n,
            "IntegralMomentOfNormalEvaluation"))


class IntegralMomentOfScaledNormalEvaluation(Functional):
    r"""v -> \int_F (v . n~) p ds."""

    def __init__(self, ref_el, Q, P_at_qpts, facet):
        space_dim = ref_el.get_spatial_dimension()
        n = ref_el.compute_scaled_normal(facet)
        super().__init__(*_facet_trace_moment_args(
            ref_el, Q, P_at_qpts, space_dim - 1, facet, n,
            "IntegralMomentOfScaledNormalEvaluation"))


class IntegralMomentOfTangentialEvaluation(Functional):
    r"""v -> \int_e (v . t) p ds (2D)."""

    def __init__(self, ref_el, Q, P_at_qpts, facet):
        space_dim = ref_el.get_spatial_dimension()
        assert space_dim == 2
        t = ref_el.compute_edge_tangent(facet)
        super().__init__(*_facet_trace_moment_args(
            ref_el, Q, P_at_qpts, space_dim - 1, facet, t,
            "IntegralMomentOfScaledTangentialEvaluation"))


class IntegralMomentOfEdgeTangentEvaluation(Functional):
    r"""v -> \int_e (v . t) p ds for p tabulated at the edge rule Q."""

    def __init__(self, ref_el, Q, P_at_qpts, edge):
        t = ref_el.compute_edge_tangent(edge)
        super().__init__(*_facet_trace_moment_args(
            ref_el, Q, P_at_qpts, 1, edge, t,
            "IntegralMomentOfEdgeTangentEvaluation"))


class IntegralMomentOfFaceTangentEvaluation(Functional):
    r"""v -> \int_F (v x n) . p dA, expressed through the double cross
    product: the weight for component i is w * (n x (p x n))_i."""

    def __init__(self, ref_el, Q, P_at_qpts, facet):
        n = ref_el.compute_scaled_normal(facet)
        space_dim = ref_el.get_spatial_dimension()
        transform = ref_el.get_entity_transform(space_dim - 1, facet)
        pts = np.asarray(transform(Q.get_points()))
        phi = np.asarray(P_at_qpts).T                     # (npts, 3)
        phixn = np.cross(phi, n[None, :])
        W = Q.get_weights()[:, None] * np.cross(n[None, :], phixn)
        npts = W.shape[0]
        super().__init__(ref_el, (space_dim,), "IntegralMomentOfFaceTangentEvaluation",
                         pts,
                         pt_ids=np.repeat(np.arange(npts), space_dim),
                         weights=W.ravel(),
                         comps=np.tile(np.arange(space_dim), npts))


def _legendre(n, x):
    """P_n at points x by the three-term recurrence."""
    x = np.asarray(x)
    p0 = np.ones_like(x)
    if n == 0:
        return p0
    p1 = x.copy()
    for k in range(1, n):
        p0, p1 = p1, ((2 * k + 1) * x * p1 - k * p0) / (k + 1)
    return p1


class IntegralLegendreDirectionalMoment(FrobeniusIntegralMoment):
    """v -> int_e (v . s) P_k along an edge, P_k Legendre of degree k."""

    def __init__(self, cell, s, entity, mom_deg, quad_deg, nm=""):
        assert cell.get_spatial_dimension() == 2
        entity = (1, entity)
        Q = quadrature_schemes.create_quadrature(cell, quad_deg, entity=entity)
        x = cell.compute_barycentric_coordinates(Q.get_points(), entity=entity)
        f_at_qpts = _legendre(mom_deg, x[:, 1] - x[:, 0])
        f_at_qpts /= Q.jacobian_determinant()
        f_at_qpts = np.multiply(np.asarray(s)[..., None], f_at_qpts)
        super().__init__(cell, Q, f_at_qpts, nm=nm)


class IntegralLegendreNormalMoment(IntegralLegendreDirectionalMoment):
    def __init__(self, cell, entity, mom_deg, comp_deg):
        n = cell.compute_scaled_normal(entity)
        super().__init__(cell, n, entity, mom_deg, comp_deg,
                         "IntegralLegendreNormalMoment")


class IntegralLegendreTangentialMoment(IntegralLegendreDirectionalMoment):
    def __init__(self, cell, entity, mom_deg, comp_deg):
        t = cell.compute_edge_tangent(entity)
        super().__init__(cell, t, entity, mom_deg, comp_deg,
                         "IntegralLegendreTangentialMoment")


class IntegralLegendreBidirectionalMoment(IntegralLegendreDirectionalMoment):
    """tau -> int_e (s1 . tau . s2) P_k."""

    def __init__(self, cell, s1, s2, entity, mom_deg, comp_deg, nm=""):
        super().__init__(cell, np.outer(s1, s2), entity, mom_deg, comp_deg, nm=nm)


class IntegralLegendreNormalNormalMoment(IntegralLegendreBidirectionalMoment):
    def __init__(self, cell, entity, mom_deg, comp_deg):
        n = cell.compute_scaled_normal(entity)
        super().__init__(cell, n, n, entity, mom_deg, comp_deg,
                         "IntegralNormalNormalLegendreMoment")


class IntegralLegendreNormalTangentialMoment(IntegralLegendreBidirectionalMoment):
    def __init__(self, cell, entity, mom_deg, comp_deg):
        n = cell.compute_scaled_normal(entity)
        t = cell.compute_edge_tangent(entity)
        super().__init__(cell, n, t, entity, mom_deg, comp_deg,
                         "IntegralNormalTangentialLegendreMoment")


class IntegralLegendreTangentialTangentialMoment(IntegralLegendreBidirectionalMoment):
    def __init__(self, cell, entity, mom_deg, comp_deg):
        t = cell.compute_edge_tangent(entity)
        super().__init__(cell, t, t, entity, mom_deg, comp_deg,
                         "IntegralTangentialTangentialLegendreMoment")
