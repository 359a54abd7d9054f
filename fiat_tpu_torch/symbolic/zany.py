"""Shared machinery for physically-mapped ("zany") basis transformations.

Counterpart of ``fiat_tpu/symbolic/zany.py``.  Every zany family's
transformation matrix is assembled from the same small set of geometric
quantities -- Jacobians, facet frames, derivative jets -- evaluated on
scalars: numpy for static geometry, 0-d torch tensors on the geometry's
device otherwise.  This module centralises them:

* ``ZanyCtx``     -- a per-(cell, coordinate_mapping) context that computes
                     each geometric quantity once and memoises it.  Family
                     recipes never call the geometry callbacks directly.
* ``JetLayout``   -- row/column bookkeeping for elements whose dual starts
                     with per-vertex derivative jets followed by edge rows.
* fill helpers    -- ``put_vertex_jets``, ``edge_moment_rows``,
                     ``jet_couple``, ``scale_jet_columns``,
                     ``facet_moment_block``, ``sym_eval_block``,
                     ``unmap_piola_rows``: the recurring block patterns,
                     written once and parameterised by small coefficient
                     tables in the family modules.
* ``PiolaBubbleElement`` -- base for facet-bubble Stokes macroelements.

Behavioural parity: FInAT's ``finat/{argyris,piola_mapped,aw,morley}.py``
helper semantics, re-expressed around the context/layout design (FInAT
re-derives each quantity inside every family file).  The cell's own
vectors are numpy; where the geometry is a tensor they join it on its
device (``_on``) before they meet it, and tensors enter object arrays
entrywise (``physically_mapped.assign`` / ``as_scalar``).
"""

from itertools import combinations_with_replacement
from math import comb, factorial, prod

import numpy as np
import torch

from .fiat_bridge import FiatElement
from .physically_mapped import (PhysicallyMappedElement, adjugate, as_scalar,
                                assign, determinant, identity)
from .point_set import _is_traced


def _shape(M):
    """Shape of an array, a tensor or nested sequences of scalars."""
    if hasattr(M, "shape"):
        return tuple(M.shape)
    return (len(M),) + _shape(M[0]) if isinstance(M, (list, tuple)) else ()


def as_obj(M):
    """An array of scalars -- numpy, a tensor, or nested sequences of
    either -- as an object ndarray, entrywise: a tensor's entries stay 0-d
    tensors on its device."""
    out = np.empty(_shape(M), dtype=object)
    for idx in np.ndindex(out.shape):
        v = M
        for i in idx:
            v = v[i]
        out[idx] = v
    return out


def _on(x, like):
    """The cell's numpy vector ``x`` where it meets geometry ``like``: as
    is beside numpy, else a tensor on ``like``'s device and dtype."""
    if _is_traced(like):
        return torch.as_tensor(x, dtype=like.dtype, device=like.device)
    return x


def sym_jet(A, order):
    """Transformation of a symmetric derivative jet of ``order`` under the
    linear map ``A``: rows/cols indexed by sorted multi-indices, entries
    summed over all index interleavings (covariant tensor power of A
    restricted to the symmetric subspace)."""
    if order == 0:
        return identity(1)
    n = A.shape[0]
    slots = list(combinations_with_replacement(range(n), order))
    pos = {s: k for k, s in enumerate(slots)}
    B = np.full((len(slots), len(slots)), 0.0, dtype=object)
    # walk every unordered row index against every ORDERED column index:
    # the symmetric-power entry is the permanent-style sum over matchings
    from itertools import product as iproduct
    for r, row in enumerate(slots):
        for colseq in iproduct(range(n), repeat=order):
            c = pos[tuple(sorted(colseq))]
            term = prod((A[colseq[k], row[k]] for k in range(order)),
                        start=1.0)
            B[r, c] = B[r, c] + term
    return B


def sym_powers(t, order):
    """Symmetric monomial powers of a vector with multinomial
    multiplicities: order 1 -> t_i; order 2 -> [t0^2, 2 t0 t1, t1^2, ...]
    over sorted multi-indices (matches the vertex-jet column ordering)."""
    if order == 0:
        return [1.0]
    n = len(t)
    out = []
    for idx in combinations_with_replacement(range(n), order):
        counts = [idx.count(i) for i in range(n)]
        mult = factorial(order)
        for c in counts:
            mult //= factorial(c)
        out.append(mult * prod((t[i] for i in idx), start=1.0))
    return out


def jet_block_dim(sd, k):
    """Number of order-k symmetric derivative components in sd dims."""
    return comb(sd + k - 1, k)


def jet_dim(sd, vorder):
    """Total size of a vertex jet of orders 0..vorder."""
    return comb(sd + vorder, vorder)


class ZanyCtx:
    """Memoised physical-geometry quantities for one transformation.

    All entries are scalars (floats, numpy or 0-d tensor scalars); derived
    matrices are numpy object arrays so family recipes can slice and
    multiply them freely.
    """

    def __init__(self, cell, coordinate_mapping):
        self.cell = cell
        self.cm = coordinate_mapping
        self.sd = cell.get_spatial_dimension()
        self._memo = {}

    def _get(self, key, build):
        if key not in self._memo:
            self._memo[key] = build()
        return self._memo[key]

    # -- pointwise Jacobian data -------------------------------------------
    @property
    def center(self):
        return self._get("center", lambda: self.cell.make_points(
            self.sd, 0, self.sd + 1)[0])

    @property
    def J(self):
        return self._get("J", lambda: self.cm.jacobian_at(self.center))

    @property
    def J_obj(self):
        return self._get("J_obj", lambda: as_obj(
            [[self.J[i, j] for j in range(self.sd)]
             for i in range(self.sd)]))

    @property
    def detJ(self):
        return self._get("detJ", lambda: self.cm.detJ_at(self.center))

    @property
    def vertex_jacobians(self):
        return self._get("vJ", lambda: [
            self.cm.jacobian_at(v) for v in self.cell.get_vertices()])

    @property
    def h(self):
        """Cell size per vertex."""
        return self._get("h", self.cm.cell_size)

    def jet(self, order):
        """sym_jet of the cell-centre Jacobian (memoised per order)."""
        return self._get(("jet", order), lambda: sym_jet(self.J_obj, order))

    @property
    def piola_inv(self):
        """adj(J): the inverse contravariant-Piola map up to detJ."""
        return self._get("piola_inv", lambda: adjugate(self.J_obj))

    # -- physical facet data ------------------------------------------------
    @property
    def edge_lengths(self):
        return self._get("pel", self.cm.physical_edge_lengths)

    @property
    def phys_normals(self):
        return self._get("pns", self.cm.physical_normals)

    @property
    def phys_tangents(self):
        return self._get("pts", self.cm.physical_tangents)

    @property
    def ref_normals(self):
        return self._get("rns", self.cm.reference_normals)

    @property
    def ref_tangents(self):
        return self._get("rts",
                         self.cm.normalized_reference_edge_tangents)

    # -- edge/facet frames ---------------------------------------------------
    def edge_nt(self, e, face=None):
        """(Bnn, Bnt, Jt): normal-derivative edge frame.  Bnn rescales the
        reference normal derivative, Bnt couples it into the tangential
        one, Jt is the pushed-forward (unnormalised) tangent."""
        def build():
            t = self.cell.compute_edge_tangent(e)
            if self.sd == 2:
                nh = np.array([t[1], -t[0]])
            else:
                nf = self.cell.compute_scaled_normal(face)
                nh = np.cross(t, nf / np.linalg.norm(nf))
            Jn, Jt = self.J @ _on(nh, self.J), self.J @ _on(t, self.J)
            g_nt, g_tt = Jn @ Jt, Jt @ Jt
            scale = np.linalg.norm(t)
            return (self.detJ / g_tt * scale, g_nt / g_tt / scale, Jt)
        return self._get(("edge_nt", e, face), build)

    def facet_nt(self, f):
        """(Bnt, Btt): frame for contravariant-Piola facet moments --
        couples the normal moment into the tangential ones (Bnt) and
        rescales the tangential block (Btt)."""
        def build():
            if self.sd == 2:
                Bnn, Bnt, _ = self.edge_nt(f)
                # same algebra, different normalisation: strip the length
                # factors edge_nt folds in
                t = self.cell.compute_edge_tangent(f)
                scale = np.linalg.norm(t)
                return (-1 * Bnt * scale, Bnn * scale)
            ths = self.cell.compute_tangents(2, f)
            nh = np.cross(*ths)
            nh = nh / np.dot(nh, nh)
            orth = np.cross(ths, nh[None, :], axis=1)
            Jt, Jo = self.J @ _on(ths.T, self.J), self.J @ _on(orth.T, self.J)
            A = as_obj(Jt.T @ Jo)
            b = as_obj((self.J @ _on(nh, self.J) @ Jt)[:, None])[:, 0]
            beta = determinant(A)
            alpha = (ths @ ths.T) @ (adjugate(A) @ b)
            return (alpha / as_scalar(beta), self.detJ / beta)
        return self._get(("facet_nt", f), build)

    def face_nn(self, f):
        """(Bnn, Bnt): 3D face normal-derivative frame (Morley-type),
        Bnt resolved onto the face's three edges."""
        def build():
            ths = self.cell.compute_tangents(self.sd - 1, f)
            nh = np.cross(*ths)
            area_hat = np.linalg.norm(nh)
            nh = nh / np.dot(nh, nh)
            Jn, Jt = self.J @ _on(nh, self.J), self.J @ _on(ths.T, self.J)
            g_nt, g_tt = Jn @ Jt, Jt.T @ Jt
            det_g = g_tt[0, 0] * g_tt[1, 1] - g_tt[0, 1] * g_tt[1, 0]
            adj_g = [[g_tt[1, 1], -1 * g_tt[1, 0]],
                     [-1 * g_tt[0, 1], g_tt[0, 0]]]
            Bnn = self.detJ / det_g ** 0.5 * area_hat
            w = [sum(g_nt[i] * adj_g[i][j] for i in range(2)) / det_g
                 * area_hat for j in range(2)]
            return Bnn, (-1 * (w[0] + w[1]), w[0], w[1])
        return self._get(("face_nn", f), build)

    def edge_hess(self, e):
        """(B2, beta): second-derivative edge frame in the physical
        normal/tangent basis (C2 and Wu-Xu families).  B2[0,0] rescales
        the nn-moment; beta couples it into the endpoint gradients."""
        def build():
            sd = self.sd
            G = as_obj([[u[e, j] for j in range(sd)]
                        for u in (self.phys_normals, self.phys_tangents)])
            Gh = as_obj([[u[e, j] for j in range(sd)]
                         for u in (self.ref_normals, self.ref_tangents)])
            B2 = (sym_jet(Gh.T, 2) @ self.jet(2)) @ sym_jet(G, 2)
            beta = B2[0, 1:] @ G / as_scalar(self.edge_lengths[e])
            return B2, beta
        return self._get(("edge_hess", e), build)

    def edge_grad(self, e):
        """(B1, alpha): first-derivative edge frame in the physical
        normal/tangent basis.  B1[0,0] rescales the n-moment; alpha
        couples it into the endpoint values."""
        def build():
            sd = self.sd
            G = as_obj([[u[e, j] for j in range(sd)]
                        for u in (self.phys_normals, self.phys_tangents)])
            Gh = as_obj([[u[e, j] for j in range(sd)]
                         for u in (self.ref_normals, self.ref_tangents)])
            B1 = (Gh @ self.J_obj.T) @ G.T
            return B1, B1[0, 1] / self.edge_lengths[e]
        return self._get(("edge_grad", e), build)


class JetLayout:
    """Column/row arithmetic for vertex-jet + edge-row dual orderings:
    dofs run [vertex 0 jet | vertex 1 jet | ... | edge rows]."""

    def __init__(self, cell, vorder, erows=0):
        self.cell = cell
        self.sd = cell.get_spatial_dimension()
        self.vorder = vorder
        self.erows = erows
        self.vblock = jet_dim(self.sd, vorder)
        self.nverts = len(cell.get_topology()[0])

    def vcol(self, v, order=0):
        """First column of the order-k block of vertex v's jet."""
        return v * self.vblock + jet_dim(self.sd, order - 1) if order \
            else v * self.vblock

    def vjet(self, v, order):
        """Column slice of the order-k block of vertex v's jet."""
        lo = self.vcol(v, order)
        return slice(lo, lo + jet_block_dim(self.sd, order))

    def erow(self, e, k=0):
        """Row of the k-th moment of edge e."""
        return self.nverts * self.vblock + e * self.erows + k


# -- fill helpers -------------------------------------------------------------

def put_vertex_jets(V, ctx, vorder):
    """Diagonal vertex-jet blocks: order-k derivatives transform by the
    k-th symmetric Jacobian power."""
    blocks = [ctx.jet(k) for k in range(vorder + 1)]
    stride = jet_dim(ctx.sd, vorder)
    for v in sorted(ctx.cell.get_topology()[0]):
        lo = v * stride
        for B in blocks:
            hi = lo + len(B)
            V[lo:hi, lo:hi] = B
            lo = hi
    return V


def jet_couple(V, ctx, e, row, coeffs, layout, face=None, diag=None):
    """Couple one edge row into its endpoint vertex jets.

    ``coeffs[k]`` multiplies Bnt times the order-k symmetric powers of
    the pushed tangent; even orders enter antisymmetrically (+ at the
    second endpoint, - at the first), odd orders symmetrically.  ``diag``
    (if given) fills V[row, row]."""
    Bnn, Bnt, Jt = ctx.edge_nt(e, face)
    if diag is not None:
        V[row, row] = diag(Bnn)
    v0, v1 = ctx.cell.get_topology()[1][e]
    for k, ck in enumerate(coeffs):
        if ck is None:
            continue
        vals = [ck * Bnt * p for p in sym_powers(Jt, k)]
        sgn = 1.0 if k % 2 else -1.0
        for i, val in enumerate(vals):
            V[row, layout.vcol(v1, k) + i] = val
            V[row, layout.vcol(v0, k) + i] = sgn * val
    return V


def edge_moment_rows(V, ctx, layout, eorder, avg=False):
    """Normal-derivative edge moments against Jacobi polynomials: the
    k-th moment row picks up Bnn on the diagonal, couples into the
    endpoint VALUES with the Jacobi endpoint weights, and (for k>0) into
    the corresponding tangential moment row."""
    vorder = layout.vorder
    for e in sorted(ctx.cell.get_topology()[1]):
        Bnn, Bnt, _ = ctx.edge_nt(e)
        if avg:
            Bnn = Bnn * ctx.edge_lengths[e]
        v0, v1 = ctx.cell.get_topology()[1][e]
        for k in range(eorder + 1):
            r = layout.erow(e, k)
            w1 = comb(k + vorder, k)
            V[r, r] = Bnn
            V[r, layout.vcol(v1)] = w1 * Bnt
            V[r, layout.vcol(v0)] = -(-1) ** k * w1 * Bnt
            if k:
                V[r, r + eorder] = -1 * Bnt
    return V


def scale_jet_columns(V, ctx, layout, emoment_orders=()):
    """Conditioning rescale: divide order-k vertex-jet columns by h^k
    (and listed edge-moment column groups by the average endpoint h)."""
    h = ctx.h
    for v in sorted(ctx.cell.get_topology()[0]):
        f = 1.0
        for k in range(1, layout.vorder + 1):
            f = f / h[v]
            V[:, layout.vjet(v, k)] *= as_scalar(f)
    for e, cols, power in emoment_orders:
        verts = ctx.cell.get_topology()[1][e]
        he = sum(h[v] for v in verts) / len(verts)
        V[:, cols] *= as_scalar((1 / he) ** power)
    return V


def facet_moment_block(ctx, moment_degree):
    """Block transform of per-facet (normal, tangential...) moment
    groups: Bnt scatters the normal moment into the tangential slots,
    Btt rescales them; one group per facet-polynomial mode."""
    from ..core.expansions import polynomial_dimension
    sd = ctx.sd
    facets = ctx.cell.get_topology()[sd - 1]
    nmodes = polynomial_dimension(
        ctx.cell.construct_subelement(sd - 1), moment_degree)
    group = sd
    V = identity(len(facets) * nmodes * group)
    for f in sorted(facets):
        Bnt, Btt = ctx.facet_nt(f)
        base = f * nmodes * group
        for m in range(nmodes):
            lo = base + m * group
            tan = list(range(lo + 1, lo + group))
            assign(V, (tan, lo), Bnt)
            assign(V, (tan, tan), Btt)
    return V


def sym_eval_block(ctx):
    """Pointwise transform of symmetric-tensor components (upper-triangle
    ordering): conjugation by adj(J) restricted to symmetric matrices,
    off-diagonal columns doubled."""
    K = ctx.piola_inv
    sd = ctx.sd
    comps = [(i, j) for i in range(sd) for j in range(i, sd)]
    W = np.full((len(comps), len(comps)), 0.0, dtype=object)
    for p, (i, j) in enumerate(comps):
        for q, (m, n) in enumerate(comps):
            scale = 1.0 if m == n else 2.0
            W[p, q] = scale * 0.5 * (K[i, m] * K[j, n] + K[j, m] * K[i, n])
    return W


def unmap_piola_rows(V, ctx, dofs, nodes, skip_dims=()):
    """Undo the contravariant Piola map dof-by-dof: derivative-type
    functionals rescale by detJ, pointwise vector evaluations (in groups
    of sd) invert by adj(J)."""
    Finv = ctx.piola_inv
    for dim in dofs:
        if dim in skip_dims:
            continue
        for ids in dofs[dim].values():
            k = 0
            while k < len(ids):
                i = ids[k]
                if nodes[i].deriv_dict:
                    V[i, i] = ctx.detJ
                    k += 1
                else:
                    grp = ids[k:k + ctx.sd]
                    V[np.ix_(grp, grp)] = Finv
                    k += ctx.sd
    return V


class PiolaBubbleElement(PhysicallyMappedElement, FiatElement):
    """Facet-bubble Stokes macroelements: tangential facet dofs are
    constrained away; the transformation un-Piolas the interior dofs and
    resolves each facet bubble's normal component."""

    def __init__(self, fiat_element):
        if set(fiat_element.mapping()) != {"contravariant piola"}:
            raise ValueError(f"{type(fiat_element).__name__} needs to be "
                             "Piola mapped.")
        super().__init__(fiat_element)
        sd = self.cell.get_spatial_dimension()
        full = fiat_element.entity_dofs()
        dropped = sum(len(ids) - 1 for ids in full[sd - 1].values())
        reduced = {dim: dict(ent) for dim, ent in full.items()}
        reduced[sd - 1] = {f: [f + full[sd - 1][0][0]]
                           for f in sorted(full[sd - 1])}
        self._entity_dofs = reduced
        self._space_dimension = fiat_element.space_dimension() - dropped

    def entity_dofs(self):
        return self._entity_dofs

    def space_dimension(self):
        return self._space_dimension

    def basis_transformation(self, coordinate_mapping):
        ctx = ZanyCtx(self.cell, coordinate_mapping)
        sd = ctx.sd
        dofs = self.entity_dofs()
        rows = self._element.entity_dofs()
        nodes = self._element.get_dual_set().nodes
        V = identity(self._element.space_dimension(),
                     self.space_dimension())

        unmap_piola_rows(V, ctx, dofs, nodes, skip_dims=(sd - 1,))

        for f in sorted(dofs[sd - 1]):
            Bnt, Btt = ctx.facet_nt(f)
            keep, = dofs[sd - 1][f]
            tan_rows = rows[sd - 1][f][1:]
            assign(V, (tan_rows, keep), Bnt)
            cons = dofs[sd - 1][f][1:]
            if cons:
                assign(V, (tan_rows, cons), Btt)

        self._couple_constraints(V, ctx, dofs, rows, nodes)
        return V.T

    def _couple_constraints(self, V, ctx, dofs, rows, nodes):
        """Fix the normal/tangential moment discrepancy on elements whose
        constrained rows also see the vertex dofs."""
        sd = ctx.sd
        ndof = self.space_dimension()
        nrows = self._element.space_dimension()
        if not dofs[0][0] or nrows <= ndof:
            return
        low = max(d for d in range(sd - 1) if dofs[d][0])
        vcols = [i for ids in dofs[low].values() for i in ids
                 if nodes[i].max_deriv_order == 0]
        fcols = [i for ids in dofs[sd - 1].values() for i in ids]
        col_of = {c: k for k, c in enumerate(vcols)}
        T = np.full((len(fcols), len(vcols)), 0.0, dtype=object)
        frow_of = {c: k for k, c in enumerate(fcols)}
        for f in sorted(dofs[sd - 1]):
            ts = ctx.cell.compute_tangents(sd - 1, f)
            nh = np.array([ts[0][1], -ts[0][0]]) if sd == 2 \
                else np.cross(*ts)
            coupling = ((-1 / sd) * nh) @ ctx.piola_inv
            for v in ctx.cell.connectivity[(sd - 1, low)][f]:
                cols = [col_of[i] for i in dofs[low][v] if i in col_of]
                for fd in dofs[sd - 1][f]:
                    T[frow_of[fd], cols] = coupling
        V[ndof:, vcols] += V[ndof:, fcols] @ T
