"""fiat_tpu_torch: the PyTorch/CUDA port of fiat_tpu.

Host construction (cells, expansion sets, dual sets, nodal solves) is
float64 numpy/scipy, as in fiat_tpu.  Device tabulation runs eagerly on
torch tensors: hand-written CUDA kernels on the card (built from
``csrc/`` at first use by ``load_kernels``), their plain PyTorch versions
on the CPU.  Nothing here imports JAX.
"""

from fiat_tpu_torch.core import cells  # noqa: F401
from fiat_tpu_torch.core.cells import (  # noqa: F401
    TensorProductCell, UFCHexahedron, UFCQuadrilateral, default_simplex, symmetric_simplex,
    ufc_cell, ufc_simplex)
from fiat_tpu_torch.core.finite_element import (  # noqa: F401
    CiarletElement, FiniteElement, entity_support_dofs)
from fiat_tpu_torch.core.quadrature import make_quadrature  # noqa: F401
from fiat_tpu_torch.core.quadrature_schemes import create_quadrature  # noqa: F401
from fiat_tpu_torch.elements import (  # noqa: F401
    DPC, AlfeldC2, AlfeldSorokina, Argyris, ArnoldQin, ArnoldWinther, ArnoldWintherNC, Bell,
    BernardiRaugel, Bernstein, BrambleZlamalC2, BrezziDouglasFortinMarini,
    BrezziDouglasMarini, BrezziDouglasMariniCubeEdge, BrezziDouglasMariniCubeFace, Bubble,
    ChristiansenHu, CrouzeixRaviart, CubicHermite, DiscontinuousElement,
    DiscontinuousLagrange, DiscontinuousRaviartThomas, DiscontinuousTaylor, EnrichedElement,
    FacetBubble, FDMBrokenH1, FDMBrokenL2, FDMDiscontinuousLagrange, FDMHermite, FDMLagrange,
    FDMQuadrature, FlattenedDimensions, GaussLegendre, GaussLobattoLegendre, GaussRadau,
    GopalakrishnanLedererSchoberlFirstKind, GopalakrishnanLedererSchoberlSecondKind,
    GuzmanNeilanFirstKindH1, GuzmanNeilanH1div, GuzmanNeilanSecondKindH1, Hcurl, Hdiv,
    HDivTrace, HellanHerrmannJohnson, Histopolation, HsiehCloughTocher, HuZhang,
    IntegratedLegendre, JohnsonMercier, KongMulderVeldhuizen, Lagrange, Legendre,
    MardalTaiWinther, MixedElement, Morley, Nedelec, NedelecSecondKind,
    NodalEnrichedElement, P0, QuadratureElement, QuadraticPowellSabin6,
    QuadraticPowellSabin12, RaviartThomas, Regge, RestrictedElement, Serendipity,
    TensorProductElement, TrimmedSerendipityCurl, TrimmedSerendipityDiv,
    TrimmedSerendipityEdge, TrimmedSerendipityFace, Walkington, WuXuH3NC, WuXuRobustH3NC)
from fiat_tpu_torch.ops import device_tabulator  # noqa: F401
from fiat_tpu_torch.ops.kernels import load_kernels  # noqa: F401
