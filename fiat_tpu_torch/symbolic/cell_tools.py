"""Cell utilities pass-through (counterpart of
``fiat_tpu/symbolic/cell_tools.py``, role of FInAT's ``finat/cell_tools.py``): lets
symbolic-layer clients find the maximal complex without importing the
numeric core directly."""

from ..core.cells import max_complex  # noqa: F401
