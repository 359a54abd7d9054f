"""Registry of finite element families for the description layer.

Equivalent of FInAT's finat/ufl/elementlist.py (the port's copy of
``fiat_tpu.ufl.elementlist``): a table mapping
family names (and short names / aliases) to their value rank, Sobolev
space, reference mapping, valid degree range and cells, plus
``canonical_element_description`` which normalises user input.  The
family metadata (names, ranks, mappings, degree ranges) are mathematical
facts about the element zoo, shared with the reference by necessity."""

import warnings

import numpy as np

from .cell import Cell, TensorProductCell
from .sobolevspace import (H1, H2, H3, L2, HCurl, HCurlDiv, HDiv, HDivDiv,
                           HEin, HInf)

# family name -> (family, short_name, value_rank, sobolev_space,
#                 mapping, (kmin, kmax), cellnames)
ufl_elements = {}

# alias name -> fn(family, tdim, order, form_degree) -> (family, order)
aliases = {}


def register_element(family, short_name, value_rank, sobolev_space,
                     mapping, degree_range, cellnames):
    """Register a finite element family (and its short name)."""
    if family in ufl_elements:
        raise ValueError(f"Element family {family!r} already registered.")
    data = (family, short_name, value_rank, sobolev_space, mapping,
            degree_range, cellnames)
    ufl_elements[family] = data
    if short_name is not None:
        ufl_elements[short_name] = data


def register_alias(alias, to):
    aliases[alias] = to


def show_elements():
    """Print every registered family."""
    shown = set()
    for k in sorted(ufl_elements):
        data = ufl_elements[k]
        if data in shown:
            continue
        shown.add(data)
        family, short_name, rank, space, mapping, krange, cells = data
        print(f"{family} ({short_name}): rank {rank}, {space}, "
              f"mapping {mapping}, degrees {krange}, cells {cells}")


simplices = ("interval", "triangle", "tetrahedron", "pentatope")
cubes = ("interval", "quadrilateral", "hexahedron", "tesseract")
any_cell = (None, "vertex", *simplices, *cubes[1:], "prism", "pyramid")

# --- the periodic-table core -------------------------------------------
register_element("Lagrange", "CG", 0, H1, "identity", (1, None), any_cell)
register_element("Brezzi-Douglas-Marini", "BDM", 1, HDiv,
                 "contravariant Piola", (1, None), simplices[1:])
register_element("Discontinuous Lagrange", "DG", 0, L2, "identity",
                 (0, None), any_cell)
register_element("Discontinuous Taylor", "TDG", 0, L2, "identity",
                 (0, None), simplices)
register_element("Nedelec 1st kind H(curl)", "N1curl", 1, HCurl,
                 "covariant Piola", (1, None), simplices[1:])
register_element("Nedelec 2nd kind H(curl)", "N2curl", 1, HCurl,
                 "covariant Piola", (1, None), simplices[1:])
register_element("Raviart-Thomas", "RT", 1, HDiv, "contravariant Piola",
                 (1, None), simplices[1:])

# --- beyond the periodic table -----------------------------------------
register_element("Brezzi-Douglas-Fortin-Marini", "BDFM", 1, HDiv,
                 "contravariant Piola", (1, None), simplices[1:])
register_element("Crouzeix-Raviart", "CR", 0, L2, "identity", (1, None),
                 simplices[1:])
register_element("Discontinuous Raviart-Thomas", "DRT", 1, L2,
                 "contravariant Piola", (1, None), simplices[1:])
register_element("Kong-Mulder-Veldhuizen", "KMV", 0, H1, "identity",
                 (1, None), simplices[1:])

# --- tensor-valued -----------------------------------------------------
register_element("Regge", "Regge", 2, HEin, "double covariant Piola",
                 (0, None), simplices)
register_element("Hellan-Herrmann-Johnson", "HHJ", 2, HDivDiv,
                 "double contravariant Piola", (0, None),
                 ("triangle", "tetrahedron"))
register_element("Gopalakrishnan-Lederer-Schoberl 1st kind", "GLS", 2,
                 HCurlDiv, "covariant contravariant Piola", (1, None),
                 simplices[1:])
register_element("Gopalakrishnan-Lederer-Schoberl 2nd kind", "GLS2", 2,
                 HCurlDiv, "covariant contravariant Piola", (0, None),
                 simplices[1:])
register_element("Nonconforming Arnold-Winther", "AWnc", 2, HDiv,
                 "double contravariant Piola", (2, 2), ("triangle",))
register_element("Conforming Arnold-Winther", "AWc", 2, HDiv,
                 "double contravariant Piola", (3, None), ("triangle",))
register_element("Hu-Zhang", "HZ", 2, HDiv, "double contravariant Piola",
                 (3, None), ("triangle",))

# --- zany (physically mapped) ------------------------------------------
register_element("Bernardi-Raugel", "BR", 1, H1, "contravariant Piola",
                 (1, None), simplices[1:])
register_element("Bernardi-Raugel Bubble", "BRB", 1, H1,
                 "contravariant Piola", (None, None), simplices[1:])
register_element("Mardal-Tai-Winther", "MTW", 1, H1,
                 "contravariant Piola", (1, 2),
                 ("triangle", "tetrahedron"))
register_element("Hermite", "HER", 0, H1, "custom", (3, 3), simplices)
register_element("Argyris", "ARG", 0, H2, "custom", (5, None),
                 ("triangle",))
register_element("Bell", "BELL", 0, H2, "custom", (5, 5), ("triangle",))
register_element("Morley", "MOR", 0, H2, "custom", (2, 2), simplices[1:])
register_element("Nonconforming Wu-Xu", "WXnc", 0, H3, "custom", (4, 4),
                 ("triangle",))
register_element("Nonconforming Robust Wu-Xu", "WXncr", 0, H3, "custom",
                 (7, 7), ("triangle",))
register_element("Bramble-Zlamal C2", "BZ-C2", 0, H3, "custom", (9, None),
                 ("triangle",))

# --- macro elements ----------------------------------------------------
register_element("QuadraticPowellSabin6", "PS6", 0, H2, "custom", (2, 2),
                 ("triangle",))
register_element("QuadraticPowellSabin12", "PS12", 0, H2, "custom",
                 (2, 2), ("triangle",))
register_element("Hsieh-Clough-Tocher", "HCT", 0, H2, "custom", (3, None),
                 ("triangle",))
register_element("Reduced-Hsieh-Clough-Tocher", "HCT-red", 0, H2,
                 "custom", (3, 3), ("triangle",))
register_element("Johnson-Mercier", "JM", 2, HDiv,
                 "double contravariant Piola", (1, 1), simplices[1:])
register_element("Walkington", "WALK", 0, H2, "custom", (5, 5),
                 ("tetrahedron",))
register_element("Alfeld C2", "ALF-C2", 0, H3, "custom", (5, None),
                 ("triangle",))
register_element("Arnold-Qin", "AQ", 1, H1, "identity", (2, 2),
                 ("triangle",))
register_element("Reduced-Arnold-Qin", "AQ-red", 1, H1,
                 "contravariant Piola", (2, 2), ("triangle",))
register_element("Christiansen-Hu", "CH", 1, H1, "contravariant Piola",
                 (1, 1), simplices[1:])
register_element("Alfeld-Sorokina", "AS", 1, H1, "contravariant Piola",
                 (2, 2), simplices[1:])
register_element("Guzman-Neilan 1st kind H1", "GN", 1, H1,
                 "contravariant Piola", (1, None), simplices[1:])
register_element("Guzman-Neilan 2nd kind H1", "GN2", 1, H1,
                 "contravariant Piola", (1, None), simplices[1:])
register_element("Guzman-Neilan H1(div)", "GNH1div", 1, H1,
                 "contravariant Piola", (2, None), simplices[1:])
register_element("Guzman-Neilan Bubble", "GNB", 1, H1,
                 "contravariant Piola", (None, None), simplices[1:])

# --- special -----------------------------------------------------------
register_element("Boundary Quadrature", "BQ", 0, L2, "identity",
                 (0, None), any_cell)
register_element("Bubble", "B", 0, H1, "identity", (2, None), simplices)
register_element("FacetBubble", "FB", 0, H1, "identity", (2, None),
                 simplices)
register_element("Quadrature", "Quadrature", 0, L2, "identity",
                 (0, None), any_cell)
register_element("Real", "R", 0, HInf, "identity", (0, 0),
                 any_cell + ("TensorProductCell",))
register_element("Undefined", "U", 0, L2, "identity", (0, None), any_cell)
register_element("Radau", "Rad", 0, L2, "identity", (0, None),
                 ("interval",))
register_element("HDiv Trace", "HDivT", 0, L2, "identity", (0, None),
                 any_cell)

# --- spectral ----------------------------------------------------------
register_element("Gauss-Legendre", "GL", 0, L2, "identity", (0, None),
                 ("interval",))
register_element("Gauss-Lobatto-Legendre", "GLL", 0, H1, "identity",
                 (1, None), ("interval",))
register_alias("Lobatto", lambda family, dim, order, degree:
               ("Gauss-Lobatto-Legendre", order))
register_alias("Lob", lambda family, dim, order, degree:
               ("Gauss-Lobatto-Legendre", order))
register_element("Bernstein", None, 0, H1, "identity", (1, None),
                 any_cell)

# Nedelec H(div) = RT / BDM aliases
register_alias("Nedelec 1st kind H(div)", lambda family, dim, order,
               degree: ("Raviart-Thomas", order))
register_alias("N1div", lambda family, dim, order, degree:
               ("Raviart-Thomas", order))
register_alias("Nedelec 2nd kind H(div)", lambda family, dim, order,
               degree: ("Brezzi-Douglas-Marini", order))
register_alias("N2div", lambda family, dim, order, degree:
               ("Brezzi-Douglas-Marini", order))
register_alias("Discontinuous Lagrange Trace", lambda family, dim, order,
               degree: ("HDiv Trace", order))
register_alias("DGT", lambda family, dim, order, degree:
               ("HDiv Trace", order))

# --- 2014 periodic table (cube cells) ----------------------------------
register_element("Q", None, 0, H1, "identity", (1, None), cubes[1:])
register_element("DQ", None, 0, L2, "identity", (0, None), cubes[1:])
register_element("RTCE", None, 1, HCurl, "covariant Piola", (1, None),
                 ("quadrilateral",))
register_element("RTCF", None, 1, HDiv, "contravariant Piola", (1, None),
                 ("quadrilateral",))
register_element("NCE", None, 1, HCurl, "covariant Piola", (1, None),
                 ("hexahedron",))
register_element("NCF", None, 1, HDiv, "contravariant Piola", (1, None),
                 ("hexahedron",))
register_element("S", None, 0, H1, "identity", (1, None), cubes)
register_element("DPC", None, 0, L2, "identity", (0, None), cubes)
register_element("Brezzi-Douglas-Marini Cube Edge", "BDMCE", 1, HCurl,
                 "covariant Piola", (1, None), ("quadrilateral",))
register_element("Brezzi-Douglas-Marini Cube Face", "BDMCF", 1, HDiv,
                 "contravariant Piola", (1, None), ("quadrilateral",))
register_element("SminusE", "SminusE", 1, HCurl, "covariant Piola",
                 (1, None), cubes[1:3])
register_element("SminusF", "SminusF", 1, HDiv, "contravariant Piola",
                 (1, None), cubes[1:2])
register_element("SminusDiv", "SminusDiv", 1, HDiv,
                 "contravariant Piola", (1, None), cubes[1:3])
register_element("SminusCurl", "SminusCurl", 1, HCurl, "covariant Piola",
                 (1, None), cubes[1:3])
register_element("AAE", None, 1, HCurl, "covariant Piola", (1, None),
                 ("hexahedron",))
register_element("AAF", None, 1, HDiv, "contravariant Piola", (1, None),
                 ("hexahedron",))

register_alias("P", lambda family, dim, order, degree:
               ("Lagrange", order))
register_alias("DP", lambda family, dim, order, degree:
               ("Discontinuous Lagrange", order))
register_alias("RTE", lambda family, dim, order, degree:
               ("Nedelec 1st kind H(curl)", order))
register_alias("RTF", lambda family, dim, order, degree:
               ("Raviart-Thomas", order))
register_alias("N1E", lambda family, dim, order, degree:
               ("Nedelec 1st kind H(curl)", order))
register_alias("N1F", lambda family, dim, order, degree:
               ("Raviart-Thomas", order))
register_alias("BDME", lambda family, dim, order, degree:
               ("Nedelec 2nd kind H(curl)", order))
register_alias("BDMF", lambda family, dim, order, degree:
               ("Brezzi-Douglas-Marini", order))
register_alias("N2E", lambda family, dim, order, degree:
               ("Nedelec 2nd kind H(curl)", order))
register_alias("N2F", lambda family, dim, order, degree:
               ("Brezzi-Douglas-Marini", order))

# --- L2-Piola discontinuous variants ------------------------------------
register_element("DPC L2", None, 0, L2, "L2 Piola", (1, None), cubes)
register_element("DQ L2", None, 0, L2, "L2 Piola", (0, None), cubes[1:])
register_element("Gauss-Legendre L2", "GL L2", 0, L2, "L2 Piola",
                 (0, None), ("interval",))
register_element("Discontinuous Lagrange L2", "DG L2", 0, L2, "L2 Piola",
                 (0, None), any_cell)
register_alias("DP L2", lambda family, dim, order, degree:
               ("Discontinuous Lagrange L2", order))

# --- mimetic spectral ----------------------------------------------------
register_element("Extended-Gauss-Legendre", "EGL", 0, H1, "identity",
                 (2, None), ("interval",))
register_element("Extended-Gauss-Legendre Edge", "EGL-Edge", 0, L2,
                 "identity", (1, None), ("interval",))
register_element("Extended-Gauss-Legendre Edge L2", "EGL-Edge L2", 0, L2,
                 "L2 Piola", (1, None), ("interval",))
register_element("Gauss-Lobatto-Legendre Edge", "GLL-Edge", 0, L2,
                 "identity", (0, None), ("interval",))
register_element("Gauss-Lobatto-Legendre Edge L2", "GLL-Edge L2", 0, L2,
                 "L2 Piola", (0, None), ("interval",))

# --- direct serendipity --------------------------------------------------
register_element("Direct Serendipity", "Sdirect", 0, H1, "physical",
                 (1, None), ("quadrilateral",))
register_element("Direct Serendipity Full H(div)", "Sdirect H(div)", 1,
                 HDiv, "physical", (1, None), ("quadrilateral",))
register_element("Direct Serendipity Reduced H(div)",
                 "Sdirect H(div) red", 1, HDiv, "physical", (1, None),
                 ("quadrilateral",))


def _feec_table(r, suffix=""):
    """(family name, dimension, form degree) -> (family, order).

    The exterior-calculus complexes: trimmed (P-/Q-/S-) and full
    (P/S) families per dimension and form degree."""
    dg = "DP" + suffix
    dq = "DQ" + suffix
    dpc = "DPC" + suffix
    return {
        "P- Lambda" + suffix: (
            (("P", r), (dg, r - 1)),
            (("P", r), ("RTE", r), (dg, r - 1)),
            (("P", r), ("N1E", r), ("N1F", r), (dg, r - 1)),
        ),
        "P Lambda" + suffix: (
            (("P", r), (dg, r)),
            (("P", r), ("BDME", r), (dg, r)),
            (("P", r), ("N2E", r), ("N2F", r), (dg, r)),
        ),
        "Q- Lambda" + suffix: (
            (("Q", r), (dq, r - 1)),
            (("Q", r), ("RTCE", r), (dq, r - 1)),
            (("Q", r), ("NCE", r), ("NCF", r), (dq, r - 1)),
        ),
        "S Lambda" + suffix: (
            (("S", r), (dpc, r)),
            (("S", r), ("BDMCE", r), (dpc, r)),
            (("S", r), ("AAE", r), ("AAF", r), (dpc, r)),
        ),
    }


def feec_element(family, n, r, k):
    """FEEC notation lookup: n = dimension, r = order, k = form degree."""
    table = _feec_table(r)
    table["P-"] = table["P- Lambda"]
    table["P"] = table["P Lambda"]
    table["Q-"] = table["Q- Lambda"]
    table["S"] = table["S Lambda"]
    return table[family][n - 1][k]


def feec_element_l2(family, n, r, k):
    """FEEC notation with an L2-Piola final space."""
    table = _feec_table(r, suffix=" L2")
    table["P- L2"] = table["P- Lambda L2"]
    table["P L2"] = table["P Lambda L2"]
    table["Q- L2"] = table["Q- Lambda L2"]
    table["S L2"] = table["S Lambda L2"]
    return table[family][n - 1][k]


for _name in ("P- Lambda", "P Lambda", "Q- Lambda", "S Lambda",
              "P-", "Q-"):
    register_alias(_name, lambda family, dim, order, degree:
                   feec_element(family, dim, order, degree))
for _name in ("P- Lambda L2", "P Lambda L2", "Q- Lambda L2",
              "S Lambda L2", "P- L2", "Q- L2"):
    register_alias(_name, lambda family, dim, order, degree:
                   feec_element_l2(family, dim, order, degree))


def canonical_element_description(family, cell, order, form_degree):
    """Normalise (family, cell, order, form_degree) against the registry.

    Returns (family, short_name, order, reference_value_shape,
    sobolev_space, mapping, embedded_degree)."""
    if cell is not None:
        tdim = cell.topological_dimension
        cellname = cell.cellname if isinstance(cell, Cell) else None
    else:
        tdim = None
        cellname = None

    # FEEC shorthand "P"/"S" with a form degree
    if form_degree is not None and family in ("P", "S"):
        family, order = feec_element(family, tdim, order, form_degree)
    if form_degree is not None and family in ("P L2", "S L2"):
        family, order = feec_element_l2(family, tdim, order, form_degree)

    while family in aliases:
        if tdim is None:
            raise ValueError("Need dimension to handle element aliases.")
        family, order = aliases[family](family, tdim, order, form_degree)

    if family not in ufl_elements:
        raise ValueError(f"Unknown finite element {family!r}.")

    (family, short_name, value_rank, sobolev_space, mapping, krange,
     cellnames) = ufl_elements[family]

    # CG/DG requested on a cube or product cell become Q/DQ
    if (cellname in set(cubes) - set(simplices)
            or isinstance(cell, TensorProductCell)):
        if family == "Lagrange":
            family = "Q"
        elif family == "Discontinuous Lagrange":
            if order >= 1:
                warnings.warn(f"Discontinuous Lagrange requested on "
                              f"{cell.cellname}, creating DQ element.")
            family = "DQ"
        elif family == "Discontinuous Lagrange L2":
            if order >= 1:
                warnings.warn(f"Discontinuous Lagrange L2 requested on "
                              f"{cell.cellname}, creating DQ L2 element.")
            family = "DQ L2"

    if not (cellname is None or cellname in cellnames):
        raise ValueError(
            f"Cellname {cellname!r} invalid for {family!r} element.")

    if order is not None:
        if krange is None:
            raise ValueError(
                f"Order {order} invalid for {family!r}; should be None.")
        kmin, kmax = krange
        if not (kmin is None or (np.asarray(order) >= kmin).all()):
            raise ValueError(f"Order {order} invalid for {family!r}.")
        if not (kmax is None or (np.asarray(order) <= kmax).all()):
            raise ValueError(f"Order {order} invalid for {family!r}.")

    if value_rank == 2:
        if tdim is None:
            raise ValueError("Cannot infer element shape without a cell.")
        reference_value_shape = (tdim, tdim)
    elif value_rank == 1:
        if tdim is None:
            raise ValueError("Cannot infer element shape without a cell.")
        reference_value_shape = (tdim,)
    elif value_rank == 0:
        reference_value_shape = ()
    else:
        raise ValueError(f"Invalid value rank {value_rank}.")

    # Families whose span exceeds degree-(order) polynomials
    embedded_degree = order
    if family == "Kong-Mulder-Veldhuizen":
        if order == 1:
            bump = 0
        elif tdim == 2 and order < 5:
            bump = 1
        else:
            bump = 2
        embedded_degree += bump
    elif family == "Mardal-Tai-Winther":
        embedded_degree = tdim + 1
    elif any(b in family for b in ("Guzman-Neilan", "Bernardi-Raugel")):
        embedded_degree = tdim

    return (family, short_name, order, reference_value_shape,
            sobolev_space, mapping, embedded_degree)
