"""Lagrange variant-string parsing.

Counterpart of ``parse_lagrange_variant`` in ``fiat_tpu/core/variants.py``:
a variant string is a comma list of at most two options, each a point
family ('equispaced', 'gll', 'spectral', ...) or a macro split ('Alfeld',
'Iso(2)', ...).  Splits are recognised but not ported yet: asking for one
raises ``NotImplementedError``.
"""

import re

_SPLITS = ("iso", "alfeld", "worsey-farin", "powell-sabin", "powell-sabin(12)")


def _families(discontinuous):
    """Point-family table: alias -> canonical recursive-nodes family."""
    table = {"equispaced": "equispaced",
             "gll": "gll",
             "spectral": "gl" if discontinuous else "gll",
             "chebyshev": "gc" if discontinuous else "lgc"}
    if discontinuous:
        table.update(gl="gl", equispaced_interior="equispaced_interior")
    return table


def parse_lagrange_variant(variant, discontinuous=False):
    """Parse a Lagrange variant string into (splitting constructor or None,
    point-family name)."""
    families = _families(discontinuous)
    options = (variant or "spectral").replace(" ", "").split(",")
    if len(options) > 2:
        raise ValueError("At most two comma-separated variant options")
    family = families["spectral"]
    for raw in options:
        opt = raw.lower()
        if opt in _SPLITS or re.fullmatch(r"iso\((\d+)\)", opt):
            raise NotImplementedError(
                f"Macro split {raw!r}: split complexes are not ported yet")
        if opt not in families:
            raise ValueError(f"Illegal variant option {raw!r}")
        family = families[opt]
    return None, family
