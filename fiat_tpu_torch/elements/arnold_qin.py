"""Arnold-Qin C0(Alfeld) quadratic Stokes macroelement: curl(HCT[-red])
+ P0 x, divergence in P0.  Counterpart of
``fiat_tpu/elements/arnold_qin.py``."""

import numpy as np

from ..core import cells as cl
from ..core import finite_element, polyset
from ..core.macro import CkPolynomialSet
from ..core.quadrature_schemes import create_quadrature
from .bernardi_raugel import BernardiRaugelDualSet
from .hct import HsiehCloughTocher


def ArnoldQinSpace(ref_el, degree, reduced=False):
    """curl of the (reduced) HCT space with the constant null mode
    swapped for P0 x, expressed in the C0 bubble basis by dual
    projection."""
    if ref_el.get_shape() != cl.TRIANGLE:
        raise ValueError("Arnold-Qin only defined on triangles")
    if degree != 2:
        raise ValueError("Arnold-Qin only defined for degree = 2")
    sd = ref_el.get_spatial_dimension()
    HCT = HsiehCloughTocher(ref_el, degree + 1, reduced=True)
    ref_complex = HCT.get_reference_complex()
    Q = create_quadrature(ref_complex, 2 * degree)
    qpts, qwts = Q.get_points(), Q.get_weights()

    stream = HCT.tabulate(1, qpts)
    members = np.stack([stream[(0, 1)], -stream[(1, 0)]], axis=1)
    if reduced:
        members = members[:9]

    # swap the constant null mode (combination [1,1,1] of the three
    # vertex streams) for P0 x
    vertex_rows = [0, 3, 6]
    mix = np.asarray([[1, 1, 1], [1, -1, 0], [0, -1, 1]])
    members[vertex_rows] = np.tensordot(mix, members[vertex_rows],
                                        axes=(-1, 0))
    center = np.asarray(ref_el.make_points(sd, 0, sd + 1))
    members[0] = qpts.T[None, :, :] - center[:, :, None]

    C0 = CkPolynomialSet(ref_complex, degree, order=0, scale=1,
                         variant="bubble")
    basis = C0.tabulate(qpts)[(0,) * sd]
    gram = (basis * qwts) @ basis.T
    duals = np.linalg.solve(gram, basis * qwts)
    return polyset.PolynomialSet(ref_complex, degree, degree,
                                 C0.get_expansion_set(),
                                 np.tensordot(members, duals,
                                              axes=(-1, -1)))


class ArnoldQin(finite_element.CiarletElement):
    """Arnold-Qin C0(Alfeld) quadratic macroelement (divergence in P0)."""

    def __init__(self, ref_el, degree=2, reduced=False):
        poly_set = ArnoldQinSpace(ref_el, degree)
        if reduced:
            order, mapping = 1, "contravariant piola"
        else:
            order, mapping = degree, "affine"
        dual = BernardiRaugelDualSet(ref_el, order, degree=degree)
        super().__init__(poly_set, dual, degree,
                         ref_el.get_spatial_dimension() - 1,
                         mapping=mapping)
