"""The batched tabulation engine for a zoo of elements.

Counterpart of ``fiat_tpu/ops/tabulate.py`` (``change_of_basis`` and
``BatchedTabulator`` with ``derivs="dmats"``, ``matmul="native"``).  Every
element's coefficients are re-expressed in the plain orthonormal Dubiner
basis of the zoo's maximum degree (lower-degree bases are prefixes of
higher-degree ones in morton order), stacked, and multiplied by one
change-of-basis matrix per derivative multi-index (the dmats form), so a
pass is ONE recurrence plus one matrix product per multi-index.

The engine here runs in plain PyTorch on the points' device; the kernel
engine is ``fused_zoo.FusedZooTabulator``, which takes the same host-built
arrays (``state``).
"""

import numpy as np
import torch

from ..core import cells as cl
from ..core import expansions


def change_of_basis(expansion_set, degree, target_expansion_set, target_degree):
    """T with phi_src_i = sum_j T[i, j] phi_tgt_j, by collocation at a
    Gauss-Legendre lattice (exact: both bases span subsets of P_target)."""
    ref_el = expansion_set.ref_el
    pts = cl.make_lattice(ref_el.get_vertices(), target_degree, variant="gl")
    src = expansion_set.tabulate(degree, pts)                 # (m_src, npts)
    tgt = target_expansion_set.tabulate(target_degree, pts)   # (m_tgt, npts)
    return np.linalg.solve(tgt.T, src.T).T                    # (m_src, m_tgt)


class BatchedTabulator:
    """Tabulate a whole zoo of nodal elements (same reference cell) in one
    program: ``tables = bt(points)`` gives {alpha: (rows, npts)}, and
    ``bt.unpack(tables)`` the per-element dicts of ``el.tabulate``."""

    def __init__(self, elements, order=0, device=None):
        cells = {e.get_reference_element() for e in elements}
        if len(cells) != 1:
            raise ValueError("BatchedTabulator needs a common reference cell")
        self.ref_el, = cells
        if any(e.is_macroelement() for e in elements):
            raise NotImplementedError(
                "Macro elements (split-complex expansions) are not ported yet; "
                "see ROADMAP.md, 'TPU kernels to port', K3")
        if not all(getattr(e, "is_nodal", lambda: False)() for e in elements):
            raise NotImplementedError("BatchedTabulator fuses nodal (Ciarlet) bases")
        self.elements = list(elements)
        self.order = order
        self.device = torch.device("cpu" if device is None else device)
        self.sd = self.ref_el.get_spatial_dimension()

        self.max_degree = max(e.get_nodal_basis().get_embedded_degree() for e in self.elements)
        self.target_es = expansions.ExpansionSet(self.ref_el)
        nexp = self.target_es.get_num_members(self.max_degree)

        blocks = []
        self.slices = []
        #: element index -> leading target-basis columns its rows can touch
        #: (a degree-d basis lives in the degree-d morton prefix)
        self.plain_nexp = {}
        cursor = 0
        for i, e in enumerate(self.elements):
            ps = e.get_nodal_basis()
            es = ps.get_expansion_set()
            deg = ps.get_embedded_degree()
            self.plain_nexp[i] = self.target_es.get_num_members(deg)
            coeffs = np.asarray(ps.get_coeffs())
            if (type(es) is type(self.target_es) and es.variant is None
                    and es.ref_el == self.ref_el):
                # plain Dubiner: prefix embedding, zero-padded, up to the
                # degree-dependent normalisation (1 at degree 0)
                ratio = float(es.get_scale(deg)) / float(self.target_es.get_scale(self.max_degree))
                T = np.zeros((coeffs.shape[-1], nexp))
                T[:, :coeffs.shape[-1]] = ratio * np.eye(coeffs.shape[-1])
            else:
                T = change_of_basis(es, deg, self.target_es, self.max_degree)
            flat = coeffs.reshape(-1, coeffs.shape[-1]) @ T
            blocks.append(flat)
            self.slices.append((cursor, cursor + flat.shape[0], coeffs.shape[:-1]))
            cursor += flat.shape[0]
        self.stacked = np.vstack(blocks)          # (rows, nexp)

        # one change-of-basis matrix per derivative multi-index:
        # D^alpha phi = (prod_k dmats[k]^T^alpha_k) @ phi
        self.alpha_mats = {}
        if self.order > 0:
            D = self.target_es.get_dmats(self.max_degree)
            for alpha in expansions.multiindices(self.sd, self.order):
                M = self.stacked
                for k, ak in enumerate(alpha):
                    for _ in range(ak):
                        M = M @ np.transpose(D[k])
                self.alpha_mats[alpha] = M
        mats = self.alpha_mats or {(0,) * self.sd: self.stacked}
        self._mats = {a: torch.as_tensor(M, device=self.device) for a, M in mats.items()}

    def state(self):
        """The host-built arrays that define the engine (see
        ``fused_zoo.FusedZooTabulator.from_arrays``)."""
        A, b = self.target_es.affine_mappings[0]
        return dict(stacked=self.stacked, alpha_mats=self.alpha_mats,
                    slices=self.slices, plain_nexp=self.plain_nexp,
                    max_degree=self.max_degree,
                    scale=float(self.target_es.get_scale(self.max_degree)),
                    affine_map=(A, b))

    def __call__(self, points):
        """{alpha: (total_rows, npts)} fused tables, in float64 on the
        engine's device."""
        pts = torch.as_tensor(points, dtype=torch.float64, device=self.device)
        phi = self.target_es._tabulate_on_cell(self.max_degree, pts)[(0,) * self.sd]
        return {a: M @ phi for a, M in self._mats.items()}

    def unpack(self, tables):
        """Split fused tables back into the per-element layout."""
        return [{a: tab[lo:hi].reshape(tuple(shape) + tuple(tab.shape[-1:]))
                 for a, tab in tables.items()}
                for lo, hi, shape in self.slices]
