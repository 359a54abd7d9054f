"""Counterpart of ``fiat_tpu/symbolic/hermite.py``. Cubic Hermite: vertex
values + gradients; gradients push forward by the per-vertex Jacobian.
Behavioural parity: FInAT's ``finat/hermite.py``, on the shared zany
engine."""

from .. import elements as fe
from .citations import cite
from .fiat_bridge import ScalarFiatElement
from .physically_mapped import PhysicallyMappedElement, as_scalar, identity
from .zany import JetLayout, ZanyCtx, as_obj


def vertex_gradient_transform(element, coordinate_mapping):
    """Identity on vertex values, J(v)/h(v) on each vertex's gradient
    block (Jacobian evaluated AT the vertex, h-scaled for conditioning)."""
    ctx = ZanyCtx(element.cell, coordinate_mapping)
    lay = JetLayout(element.cell, 1)
    V = identity(element.space_dimension())
    for v in sorted(element.cell.get_topology()[0]):
        Jv = as_obj(ctx.vertex_jacobians[v])
        g = lay.vjet(v, 1)
        V[g, g] = Jv.T * as_scalar(1 / ctx.h[v])
    return V.T


class Hermite(PhysicallyMappedElement, ScalarFiatElement):
    def __init__(self, cell, degree=3):
        cite("Ciarlet1972")
        super().__init__(fe.CubicHermite(cell))

    def basis_transformation(self, coordinate_mapping):
        return vertex_gradient_transform(self, coordinate_mapping)
