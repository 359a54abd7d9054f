"""The symbolic element layer: elements whose tabulations are array
programs (the FInAT-equivalent; SURVEY.md §2.4).

Counterpart of ``fiat_tpu/symbolic``'s base layer.  Where FInAT emits GEM
expression DAGs for the TSFC form compiler, these elements return arrays
-- host numpy for static points, torch tensors on the points' device and
in their dtype for tensor points (``UnknownPointSet``, on the CUDA card
unless the caller asks for the CPU) -- so eager torch plays the role that
XLA plays for fiat_tpu's traced arrays.  The tensor path runs torch
operations, no hand-written kernel: the kernel engine of one element is
``ops.tabulate.ElementTabulator``.  The physically mapped ("zany")
elements build their basis transformation M from the geometry callbacks'
arrays -- numpy M for numpy geometry, one float64 tensor on the
geometry's device for tensor geometry, also under ``torch.func.vmap``
over a mesh's cells -- and map the reference tables by one product."""

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
from .physically_mapped import (DirectlyDefinedElement,           # noqa: F401
                                MappedTabulation,
                                NeedsCoordinateMappingElement,
                                PhysicalGeometry, PhysicallyMappedElement)
from .argyris import Argyris                                      # noqa: F401
from .bell import Bell                                            # noqa: F401
from .hermite import Hermite                                      # noqa: F401
from .c1_macro import (HsiehCloughTocher,                        # noqa: F401
                       QuadraticPowellSabin6, QuadraticPowellSabin12,
                       ReducedHsiehCloughTocher)
from .morley import Morley                                        # noqa: F401
from .zany import PiolaBubbleElement                              # noqa: F401
from .aw import ArnoldWinther, ArnoldWintherNC                    # noqa: F401
from .hz import HuZhang                                           # noqa: F401
from .mtw import MardalTaiWinther                                 # noqa: F401
from .johnson_mercier import JohnsonMercier                       # noqa: F401
from .stokes_macro import (AlfeldSorokina, ArnoldQin,             # noqa: F401
                           BernardiRaugel, BernardiRaugelBubble,
                           ChristiansenHu, GuzmanNeilanBubble,
                           GuzmanNeilanFirstKindH1, GuzmanNeilanH1div,
                           GuzmanNeilanSecondKindH1, ReducedArnoldQin)
from .wuxu import WuXuH3NC, WuXuRobustH3NC                        # noqa: F401
from .c2_elements import AlfeldC2, BrambleZlamalC2                # noqa: F401
from .walkington import Walkington                                # noqa: F401
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
from .direct_serendipity import DirectSerendipity                 # noqa: F401
from .sympy2array import evaluate_sympy                           # noqa: F401
from .citations import cite                                       # noqa: F401
