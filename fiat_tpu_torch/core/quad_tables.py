"""The generated quadrature tables.

``core/{tri,tet,sym}quad_data.py`` are pure data (about 18.9k lines, no
imports), kept in the port as copies of the JAX package's modules of the
same names (``tests/test_torch_quadrature.py`` holds them equal).  They
are large, so they are imported on first use, not with the package.
"""

import importlib


def load_table(name):
    """The data module ``name`` (``triquad_data``, ``tetquad_data`` or
    ``symquad_data``) of this package."""
    return importlib.import_module(f"{__package__}.{name}")
