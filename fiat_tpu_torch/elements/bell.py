"""Bell element: vertex 2-jets plus degree-4-Legendre edge moments of
the normal derivative (constraint rows for the transformation theory).
Counterpart of ``fiat_tpu/elements/bell.py``, on the declarative dual
builder."""

from ..core import cells as cl
from ..core import finite_element, functionals, polyset
from ..core.dual_builder import DualBuilder
from ..core.jacobi import eval_jacobi
from ..core.quadrature_schemes import create_quadrature


class Bell(finite_element.CiarletElement):
    """The Bell element (degree 5 on triangles)."""

    def __init__(self, ref_el, degree=5):
        if ref_el.get_shape() != cl.TRIANGLE:
            raise ValueError("Bell only defined on triangles")
        if degree != 5:
            raise ValueError("Bell only defined for degree = 5.")
        b = DualBuilder(ref_el)
        b.vertex_jets(2)

        edge = ref_el.construct_subelement(1)
        Q_ref = create_quadrature(edge, 2 * (degree - 1))
        s = edge.compute_barycentric_coordinates(Q_ref.get_points())
        leg4 = eval_jacobi(0, 0, 4, s[:, 1] - s[:, 0])
        for e in b.entities(1):
            b.tag(1, e, [functionals.IntegralMomentOfNormalDerivative(
                ref_el, e, Q_ref, leg4)])

        super().__init__(polyset.ONPolynomialSet(ref_el, degree),
                         b.dual_set(), degree)
