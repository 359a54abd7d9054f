"""Variant-string parsing.

Counterpart of ``fiat_tpu/core/variants.py``: a variant string is a comma
list of at most two options, each a point or moment family ('equispaced',
'gll', 'spectral', 'integral(q)', 'point', ...) or a macro split
('Alfeld', 'Iso(2)', ...).  Splits are recognised but not ported as
variants yet: asking for one raises ``NotImplementedError`` (the split
complexes themselves live in ``core/macro.py``).
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


def _refuse_split(raw):
    opt = raw.lower()
    if opt in _SPLITS or re.fullmatch(r"iso\((\d+)\)", opt):
        raise NotImplementedError(
            f"Macro split {raw!r}: split variants are not ported yet")


def parse_lagrange_variant(variant, discontinuous=False, integral=False):
    """Parse a variant string into (splitting constructor or None,
    point-family name); with ``integral`` the families are the moment-dual
    ones ('integral', 'integral(q)', 'point')."""
    if integral:
        families, default = {"integral": None, "point": "point"}, "integral"
    else:
        families, default = _families(discontinuous), "spectral"
    options = (variant or default).replace(" ", "").split(",")
    if len(options) > 2:
        raise ValueError("At most two comma-separated variant options")
    family = families.get(default, default)
    for raw in options:
        _refuse_split(raw)
        opt = raw.lower()
        if opt.startswith("integral"):
            family = opt
        elif opt in families:
            family = families[opt]
        else:
            raise ValueError(f"Illegal variant option {raw!r}")
    return None, family


def check_format_variant(variant, degree):
    """Parse moment-dual variants: (splitting, 'point'|'integral',
    interpolant degree)."""
    splitting, family = parse_lagrange_variant(variant, integral=True)
    moment = re.fullmatch(r"integral(?:\((-?\d+)\))?", family or "integral")
    if moment:
        interpolant_degree = degree + int(moment.group(1) or 0)
        if interpolant_degree < degree:
            raise ValueError(f"Quadrature degree should be at least {degree}")
        return splitting, "integral", interpolant_degree
    if family != "point":
        raise ValueError('Choose variant="point", variant="integral" or variant="integral(q)"')
    return splitting, "point", None


def parse_quadrature_scheme(ref_el, degree, quad_scheme=None):
    """A quadrature rule from a scheme string (no splitting prefixes or
    'KMV(p)' overrides yet)."""
    from .quadrature_schemes import create_quadrature
    scheme = None
    for opt in (quad_scheme or "").split(","):
        _refuse_split(opt)
        if re.fullmatch(r"KMV\((\d+)\)", opt):
            raise NotImplementedError("KMV quadrature schemes are not ported yet")
        scheme = opt or scheme
    return create_quadrature(ref_el, degree, scheme or "default")
