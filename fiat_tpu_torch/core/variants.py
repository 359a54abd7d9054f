"""Variant-string parsing.

Counterpart of ``fiat_tpu/core/variants.py``: a variant string is a comma
list of at most two options, each a point or moment family ('equispaced',
'gll', 'spectral', 'integral(q)', 'point', ...) or a macro split
('Alfeld', 'Worsey-Farin', 'Powell-Sabin', 'Powell-Sabin(12)', 'Iso',
'Iso(k)'), which comes back as the split constructor of ``core/macro.py``
('Iso(k)' as a constructor of the degree-k ``IsoSplit`` on the lattice of
the string's point family).  Quadrature-scheme strings take a split
prefix too.
"""

import re


def _families(discontinuous):
    """Point-family table: alias -> canonical recursive-nodes family."""
    table = {"equispaced": "equispaced",
             "gll": "gll",
             "spectral": "gl" if discontinuous else "gll",
             "chebyshev": "gc" if discontinuous else "lgc"}
    if discontinuous:
        table.update(gl="gl", equispaced_interior="equispaced_interior")
    return table


def _split_table():
    from .macro import (AlfeldSplit, IsoSplit, PowellSabin12Split, PowellSabinSplit,
                        WorseyFarinSplit)
    return {
        "iso": IsoSplit,
        "alfeld": AlfeldSplit,
        "worsey-farin": WorseyFarinSplit,
        "powell-sabin": PowellSabinSplit,
        "powell-sabin(12)": PowellSabin12Split,
    }


def _parse_options(variant, families, default):
    """Split a variant string into (splitting ctor or None, family name).

    ``families`` maps recognised family spellings to canonical names;
    spellings starting with 'integral' pass through verbatim (the moment
    parser inspects the argument itself)."""
    options = (variant or default).replace(" ", "").split(",")
    if len(options) > 2:
        raise ValueError("At most two comma-separated variant options")
    splits = _split_table()
    splitting = None
    iso_k = None
    family = families.get(default, default)
    for raw in options:
        opt = raw.lower()
        iso_match = re.fullmatch(r"iso\((\d+)\)", opt)
        if opt in splits:
            splitting = splits[opt]
        elif iso_match:
            iso_k = int(iso_match.group(1))
        elif opt.startswith("integral"):
            family = opt
        elif opt in families:
            family = families[opt]
        else:
            raise ValueError(f"Illegal variant option {raw!r}")
    if iso_k is not None:
        # bind after the loop so the family option may come in either order
        iso, k, fam = splits["iso"], iso_k, family

        def splitting(T):
            return iso(T, k, fam or "gll")
    return splitting, family


def parse_lagrange_variant(variant, discontinuous=False, integral=False):
    """Parse a variant string into (splitting constructor or None,
    point-family name); with ``integral`` the families are the moment-dual
    ones ('integral', 'integral(q)', 'point')."""
    if integral:
        families, default = {"integral": None, "point": "point"}, "integral"
    else:
        families, default = _families(discontinuous), "spectral"
    splitting, family = _parse_options(variant, families, default)
    if discontinuous and splitting is not None \
            and family in ("equispaced", "gll", "lgc"):
        raise ValueError("DG macroelements with DOFs on subcell boundaries "
                         "are not unisolvent.")
    return splitting, family


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
    """A quadrature rule from a scheme string, possibly with a split prefix
    (matched as spelled: 'alfeld', 'iso', ...) or 'KMV(p)', which takes the
    degree-p KMV rule whatever the degree asked."""
    from .quadrature_schemes import create_quadrature
    splits = _split_table()
    scheme = None
    for opt in (quad_scheme or "").split(","):
        kmv = re.fullmatch(r"KMV\((\d+)\)", opt)
        if opt in splits:
            ref_el = splits[opt](ref_el)
        elif kmv:
            degree = int(kmv.group(1))
            scheme = "KMV"
        else:
            scheme = opt
    return create_quadrature(ref_el, degree, scheme or "default")
