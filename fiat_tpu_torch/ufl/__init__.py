"""Self-contained element-description layer (the UFL-equivalent).

The port's copy of ``fiat_tpu.ufl``: FInAT's ``finat.ufl`` package plus
the minimal slices of external UFL it depends on (cells, Sobolev
spaces).  These are *descriptions*: symbolic, hashable recipes for
elements, converted into tabulating elements by
``fiat_tpu_torch.factory.create_element``.  Pure Python; a description's
repr and hash are those of its counterpart in ``fiat_tpu.ufl``."""

from .cell import (Cell, CellSequence, TensorProductCell,  # noqa: F401
                   as_cell, hexahedron, interval, prism, pyramid,
                   quadrilateral, tetrahedron, triangle, vertex)
from .sobolevspace import (H1, H2, H3, L2, HCurl, HCurlDiv,  # noqa: F401
                           HDiv, HDivDiv, HEin, HInf, SobolevSpace,
                           DirectionalSobolevSpace)
from .elementlist import (canonical_element_description,  # noqa: F401
                          register_alias, register_element,
                          show_elements, ufl_elements)
from .finiteelementbase import FiniteElementBase  # noqa: F401
from .finiteelement import FiniteElement  # noqa: F401
from .mixedelement import (MixedElement, TensorElement,  # noqa: F401
                           VectorElement)
from .enrichedelement import (EnrichedElement,  # noqa: F401
                              NodalEnrichedElement)
from .hdivcurl import (HCurlElement, HDivElement,  # noqa: F401
                       WithMapping)
from .restrictedelement import RestrictedElement  # noqa: F401
from .brokenelement import BrokenElement  # noqa: F401
from .tensorproductelement import TensorProductElement  # noqa: F401
from . import pullback  # noqa: F401
from .pullback import (contravariant_piola, covariant_piola,  # noqa: F401
                       identity_pullback, l2_piola,
                       supported_pullbacks)
