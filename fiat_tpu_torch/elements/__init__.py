"""The element families ported so far: the whole ``full_zoo`` triangle
configuration (plus PS12), under fiat_tpu's names."""

from .argyris import Argyris  # noqa: F401
from .bell import Bell  # noqa: F401
from .brezzi_douglas_marini import BrezziDouglasMarini  # noqa: F401
from .discontinuous_lagrange import DiscontinuousLagrange  # noqa: F401
from .hct import HsiehCloughTocher  # noqa: F401
from .hermite import CubicHermite  # noqa: F401
from .lagrange import Lagrange  # noqa: F401
from .morley import Morley  # noqa: F401
from .nedelec import Nedelec  # noqa: F401
from .p0 import P0  # noqa: F401
from .powell_sabin import QuadraticPowellSabin6, QuadraticPowellSabin12  # noqa: F401
from .raviart_thomas import RaviartThomas  # noqa: F401
