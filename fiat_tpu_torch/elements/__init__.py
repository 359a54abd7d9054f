"""The element families, under fiat_tpu's names, with its registry
(``supported_elements``, ``extra_elements``: the same keys).

* ``full_zoo``'s triangle families (plus PS12): Lagrange and
  DiscontinuousLagrange (also on Alfeld, Worsey-Farin and Powell-Sabin
  splits), P0, RaviartThomas, Nedelec, BrezziDouglasMarini, CubicHermite,
  Morley, Argyris, Bell, HsiehCloughTocher, QuadraticPowellSabin6/12;
* the nodal simplicial families of fiat_tpu's nodality sweep that need no
  macro polynomial set: CrouzeixRaviart, DiscontinuousTaylor,
  DiscontinuousRaviartThomas, NedelecSecondKind, BrezziDouglasFortinMarini,
  Regge, HellanHerrmannJohnson, GopalakrishnanLedererSchoberlFirstKind /
  SecondKind, GaussLegendre, GaussLobattoLegendre, GaussRadau, Legendre,
  IntegratedLegendre, Bubble, FacetBubble, KongMulderVeldhuizen;
* the Stokes, elasticity and C2 families of the sweep: BernardiRaugel,
  MardalTaiWinther, ArnoldWinther / ArnoldWintherNC, HuZhang,
  JohnsonMercier, AlfeldSorokina, ArnoldQin, ChristiansenHu,
  GuzmanNeilanFirstKindH1 / SecondKindH1 (and GuzmanNeilanH1div),
  WuXuH3NC / WuXuRobustH3NC, BrambleZlamalC2, AlfeldC2 and Walkington;
* the wrappers RestrictedElement, DiscontinuousElement and
  NodalEnrichedElement;
* the interval families Histopolation, FDMLagrange,
  FDMDiscontinuousLagrange, FDMQuadrature, FDMBrokenH1, FDMBrokenL2 and
  FDMHermite;
* the tensor-product layer: TensorProductElement, FlattenedDimensions,
  Hdiv / Hcurl, and on quadrilaterals and hexahedra Serendipity, DPC, the
  trimmed serendipity families (TrimmedSerendipityEdge / Face / Div /
  Curl) and BrezziDouglasMariniCubeEdge / Face; HDivTrace;
* the composite elements MixedElement, EnrichedElement and
  QuadratureElement, and Bernstein (with its pointwise dual).
"""

from .alfeld_sorokina import AlfeldSorokina  # noqa: F401
from .argyris import Argyris  # noqa: F401
from .arnold_qin import ArnoldQin  # noqa: F401
from .arnold_winther import ArnoldWinther, ArnoldWintherNC  # noqa: F401
from .bdm_cube import BrezziDouglasMariniCubeEdge, BrezziDouglasMariniCubeFace  # noqa: F401
from .bell import Bell  # noqa: F401
from .bernardi_raugel import BernardiRaugel  # noqa: F401
from .bernstein import Bernstein  # noqa: F401
from .brezzi_douglas_fortin_marini import BrezziDouglasFortinMarini  # noqa: F401
from .brezzi_douglas_marini import BrezziDouglasMarini  # noqa: F401
from .bubble import Bubble, FacetBubble  # noqa: F401
from .c2_elements import AlfeldC2, BrambleZlamalC2  # noqa: F401
from .christiansen_hu import ChristiansenHu  # noqa: F401
from .crouzeix_raviart import CrouzeixRaviart  # noqa: F401
from .discontinuous import DiscontinuousElement  # noqa: F401
from .discontinuous_lagrange import DiscontinuousLagrange  # noqa: F401
from .discontinuous_pc import DPC  # noqa: F401
from .discontinuous_raviart_thomas import DiscontinuousRaviartThomas  # noqa: F401
from .discontinuous_taylor import DiscontinuousTaylor  # noqa: F401
from .enriched import EnrichedElement  # noqa: F401
from .fdm_element import (  # noqa: F401
    FDMBrokenH1, FDMBrokenL2, FDMDiscontinuousLagrange, FDMHermite, FDMLagrange,
    FDMQuadrature)
from .gopalakrishnan_lederer_schoberl import (  # noqa: F401
    GopalakrishnanLedererSchoberlFirstKind, GopalakrishnanLedererSchoberlSecondKind)
from .guzman_neilan import (  # noqa: F401
    GuzmanNeilanFirstKindH1, GuzmanNeilanH1div, GuzmanNeilanSecondKindH1)
from .hct import HsiehCloughTocher  # noqa: F401
from .hdiv_trace import HDivTrace  # noqa: F401
from .hdivcurl import Hcurl, Hdiv  # noqa: F401
from .hellan_herrmann_johnson import HellanHerrmannJohnson  # noqa: F401
from .hermite import CubicHermite  # noqa: F401
from .hierarchical import IntegratedLegendre, Legendre  # noqa: F401
from .histopolation import Histopolation  # noqa: F401
from .hu_zhang import HuZhang  # noqa: F401
from .johnson_mercier import JohnsonMercier  # noqa: F401
from .kong_mulder_veldhuizen import KongMulderVeldhuizen  # noqa: F401
from .lagrange import Lagrange  # noqa: F401
from .mardal_tai_winther import MardalTaiWinther  # noqa: F401
from .mixed import MixedElement  # noqa: F401
from .morley import Morley  # noqa: F401
from .nedelec import Nedelec  # noqa: F401
from .nedelec_second_kind import NedelecSecondKind  # noqa: F401
from .nodal_enriched import NodalEnrichedElement  # noqa: F401
from .p0 import P0  # noqa: F401
from .powell_sabin import QuadraticPowellSabin6, QuadraticPowellSabin12  # noqa: F401
from .quadrature_element import QuadratureElement  # noqa: F401
from .raviart_thomas import RaviartThomas  # noqa: F401
from .regge import Regge  # noqa: F401
from .restricted import RestrictedElement  # noqa: F401
from .serendipity import Serendipity  # noqa: F401
from .spectral import GaussLegendre, GaussLobattoLegendre, GaussRadau  # noqa: F401
from .tensor_product import FlattenedDimensions, TensorProductElement  # noqa: F401
from .trimmed_serendipity import (  # noqa: F401
    TrimmedSerendipityCurl, TrimmedSerendipityDiv, TrimmedSerendipityEdge,
    TrimmedSerendipityFace)
from .walkington import Walkington  # noqa: F401
from .wuxu import WuXuH3NC, WuXuRobustH3NC  # noqa: F401

#: family name -> element class (parity with FIAT/__init__.py:72-131 and
#: with ``fiat_tpu.elements``' registry, same keys)
supported_elements = {
    "Argyris": Argyris,
    "Bell": Bell,
    "Bernardi-Raugel": BernardiRaugel,
    "Bernstein": Bernstein,
    "Brezzi-Douglas-Marini": BrezziDouglasMarini,
    "Brezzi-Douglas-Fortin-Marini": BrezziDouglasFortinMarini,
    "Bubble": Bubble,
    "FacetBubble": FacetBubble,
    "Crouzeix-Raviart": CrouzeixRaviart,
    "Discontinuous Lagrange": DiscontinuousLagrange,
    "S": Serendipity,
    "DPC": DPC,
    "Discontinuous Taylor": DiscontinuousTaylor,
    "Discontinuous Raviart-Thomas": DiscontinuousRaviartThomas,
    "Hermite": CubicHermite,
    "Nonconforming Wu-Xu": WuXuH3NC,
    "Nonconforming Robust Wu-Xu": WuXuRobustH3NC,
    "Hsieh-Clough-Tocher": HsiehCloughTocher,
    "QuadraticPowellSabin6": QuadraticPowellSabin6,
    "QuadraticPowellSabin12": QuadraticPowellSabin12,
    "Alfeld C2": AlfeldC2,
    "Bramble-Zlamal C2": BrambleZlamalC2,
    "Alfeld-Sorokina": AlfeldSorokina,
    "Arnold-Qin": ArnoldQin,
    "Christiansen-Hu": ChristiansenHu,
    "Guzman-Neilan 1st kind H1": GuzmanNeilanFirstKindH1,
    "Guzman-Neilan 2nd kind H1": GuzmanNeilanSecondKindH1,
    "Guzman-Neilan H1(div)": GuzmanNeilanH1div,
    "Johnson-Mercier": JohnsonMercier,
    "Lagrange": Lagrange,
    "Kong-Mulder-Veldhuizen": KongMulderVeldhuizen,
    "Gauss-Lobatto-Legendre": GaussLobattoLegendre,
    "Gauss-Legendre": GaussLegendre,
    "Gauss-Radau": GaussRadau,
    "Histopolation": Histopolation,
    "Legendre": Legendre,
    "Integrated Legendre": IntegratedLegendre,
    "Morley": Morley,
    "Nedelec 1st kind H(curl)": Nedelec,
    "Nedelec 2nd kind H(curl)": NedelecSecondKind,
    "Raviart-Thomas": RaviartThomas,
    "Regge": Regge,
    "HDiv Trace": HDivTrace,
    "Hellan-Herrmann-Johnson": HellanHerrmannJohnson,
    "Gopalakrishnan-Lederer-Schoberl 1st kind":
        GopalakrishnanLedererSchoberlFirstKind,
    "Gopalakrishnan-Lederer-Schoberl 2nd kind":
        GopalakrishnanLedererSchoberlSecondKind,
    "Conforming Arnold-Winther": ArnoldWinther,
    "Nonconforming Arnold-Winther": ArnoldWintherNC,
    "Hu-Zhang": HuZhang,
    "Mardal-Tai-Winther": MardalTaiWinther,
    "Walkington": Walkington,
    "SminusF": TrimmedSerendipityFace,
    "SminusDiv": TrimmedSerendipityDiv,
    "SminusE": TrimmedSerendipityEdge,
    "SminusCurl": TrimmedSerendipityCurl,
    "Brezzi-Douglas-Marini Cube Face": BrezziDouglasMariniCubeFace,
    "Brezzi-Douglas-Marini Cube Edge": BrezziDouglasMariniCubeEdge,
}

extra_elements = {"P0": P0}
