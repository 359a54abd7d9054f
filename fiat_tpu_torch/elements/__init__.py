"""The element families ported so far."""

from .discontinuous_lagrange import DiscontinuousLagrange  # noqa: F401
from .lagrange import Lagrange  # noqa: F401
from .p0 import P0  # noqa: F401
