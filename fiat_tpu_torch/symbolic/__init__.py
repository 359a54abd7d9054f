"""The symbolic element layer: elements whose tabulations are array
programs (the FInAT-equivalent; SURVEY.md §2.4).

Counterpart of ``fiat_tpu/symbolic``'s base layer.  Where FInAT emits GEM
expression DAGs for the TSFC form compiler, these elements return arrays
-- host numpy for static points, torch tensors on the points' device and
in their dtype for tensor points (``UnknownPointSet``, on the CUDA card
unless the caller asks for the CPU) -- so eager torch plays the role that
XLA plays for fiat_tpu's traced arrays.  The tensor path runs torch
operations, no hand-written kernel: the kernel engine of one element is
``ops.tabulate.ElementTabulator``."""

from .base import FiniteElementBase, entity_support_dofs          # noqa: F401
from .point_set import (AbstractPointSet, FacetPointSet,          # noqa: F401
                        GaussLegendrePointSet,
                        GaussLobattoLegendrePointSet, KMVPointSet,
                        PointSet, PointSingleton, TensorPointSet,
                        UnknownPointSet)
from .quadrature import (QuadratureRule,                          # noqa: F401
                         TensorProductQuadratureRule, make_quadrature)
from .fiat_bridge import (DPC, Bernstein, BrezziDouglasFortinMarini,  # noqa: F401
                          BrezziDouglasMarini, Bubble, CrouzeixRaviart,
                          DiscontinuousLagrange, DiscontinuousTaylor,
                          FacetBubble, FiatElement,
                          GopalakrishnanLedererSchoberlFirstKind,
                          GopalakrishnanLedererSchoberlSecondKind,
                          HDivTrace, HellanHerrmannJohnson, Histopolation,
                          Lagrange, Nedelec, NedelecSecondKind,
                          RaviartThomas, Real, Regge, ScalarFiatElement,
                          Serendipity, VectorFiatElement,
                          BrezziDouglasMariniCubeEdge,
                          BrezziDouglasMariniCubeFace,
                          TrimmedSerendipityCurl, TrimmedSerendipityDiv,
                          TrimmedSerendipityEdge, TrimmedSerendipityFace)
from .tensor_product import TensorProductElement                  # noqa: F401
from .tensorfiniteelement import TensorFiniteElement              # noqa: F401
from .cube import FlattenedDimensions                             # noqa: F401
from .spectral import (FDMBrokenH1, FDMBrokenL2,                  # noqa: F401
                       FDMDiscontinuousLagrange, FDMHermite,
                       FDMLagrange, FDMQuadrature, GaussLegendre,
                       GaussLobattoLegendre, IntegratedLegendre,
                       KongMulderVeldhuizen, Legendre, SpectralElement)
from .discontinuous import DiscontinuousElement                   # noqa: F401
from .enriched import EnrichedElement                             # noqa: F401
from .mixed import (MixedElement, MixedSubElement,                # noqa: F401
                    split_mixed_evaluation)
from .nodal_enriched import NodalEnrichedElement                  # noqa: F401
from .hdivcurl import HCurlElement, HDivElement                   # noqa: F401
from .restricted import RestrictedElement                         # noqa: F401
from .quadrature_element import (QuadratureElement,               # noqa: F401
                                 make_quadrature_element)
from . import cell_tools                                          # noqa: F401
from .runtime_tabulated import RuntimeTabulated                   # noqa: F401
from .citations import cite                                       # noqa: F401
