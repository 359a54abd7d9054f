"""fiat_tpu_torch: the PyTorch/CUDA port of fiat_tpu.

Host construction (cells, expansion sets, dual sets, nodal solves) is
float64 numpy/scipy, as in fiat_tpu.  Device tabulation runs eagerly on
torch tensors: hand-written CUDA kernels on the card (built from
``csrc/`` at first use by ``load_kernels``), their plain PyTorch versions
on the CPU.  Nothing here imports JAX.
"""

from fiat_tpu_torch.core.cells import default_simplex, ufc_simplex  # noqa: F401
from fiat_tpu_torch.core.finite_element import CiarletElement, FiniteElement  # noqa: F401
from fiat_tpu_torch.elements import (  # noqa: F401
    AlfeldC2, AlfeldSorokina, Argyris, ArnoldQin, ArnoldWinther, ArnoldWintherNC, Bell,
    BernardiRaugel, BrambleZlamalC2, BrezziDouglasFortinMarini, BrezziDouglasMarini, Bubble,
    ChristiansenHu, CrouzeixRaviart, CubicHermite, DiscontinuousElement,
    DiscontinuousLagrange, DiscontinuousRaviartThomas, DiscontinuousTaylor, FacetBubble,
    FDMBrokenH1, FDMBrokenL2, FDMDiscontinuousLagrange, FDMHermite, FDMLagrange,
    FDMQuadrature, GaussLegendre, GaussLobattoLegendre, GaussRadau,
    GopalakrishnanLedererSchoberlFirstKind, GopalakrishnanLedererSchoberlSecondKind,
    GuzmanNeilanFirstKindH1, GuzmanNeilanH1div, GuzmanNeilanSecondKindH1,
    HellanHerrmannJohnson, Histopolation, HsiehCloughTocher, HuZhang,
    IntegratedLegendre, JohnsonMercier, KongMulderVeldhuizen, Lagrange, Legendre,
    MardalTaiWinther, Morley, Nedelec, NedelecSecondKind, NodalEnrichedElement, P0,
    QuadraticPowellSabin6, QuadraticPowellSabin12, RaviartThomas, Regge, RestrictedElement,
    Walkington, WuXuH3NC, WuXuRobustH3NC)
from fiat_tpu_torch.ops import device_tabulator  # noqa: F401
from fiat_tpu_torch.ops.kernels import load_kernels  # noqa: F401
