"""Element factory: descriptions -> tabulating symbolic elements.

Equivalent of FInAT's finat/element_factory.py, and the port's copy of
``fiat_tpu.factory``: converts ``fiat_tpu_torch.ufl`` element
descriptions into ``fiat_tpu_torch.symbolic`` elements via a
singledispatch ``convert``, with per-description caching keyed on the
conversion-relevant parameters.

The defaults are FInAT's, not the classes': a Lagrange description with
no variant becomes ``GaussLobattoLegendre`` and a discontinuous Lagrange
one ``GaussLegendre`` (``variant="spectral"``); name
``variant="equispaced"`` for the equispaced ``Lagrange`` and
``DiscontinuousLagrange`` of ``fiat_tpu_torch.elements``."""

import weakref
from functools import cache, singledispatch

from . import symbolic as fe
from . import ufl as ufl_desc
from .core import cells as core_cells

__all__ = ("as_fiat_cell", "create_base_element", "create_element",
           "supported_elements")


# UFL family name -> symbolic element constructor.  ``None`` marks
# families that are supported but need special handling (product-cell
# reconstruction) rather than a direct constructor.
supported_elements = {
    "Argyris": fe.Argyris,
    "Bell": fe.Bell,
    "Bernardi-Raugel": fe.BernardiRaugel,
    "Bernardi-Raugel Bubble": fe.BernardiRaugelBubble,
    "Bernstein": fe.Bernstein,
    "Brezzi-Douglas-Fortin-Marini": fe.BrezziDouglasFortinMarini,
    "Brezzi-Douglas-Marini": fe.BrezziDouglasMarini,
    "Brezzi-Douglas-Marini Cube Face": fe.BrezziDouglasMariniCubeFace,
    "Brezzi-Douglas-Marini Cube Edge": fe.BrezziDouglasMariniCubeEdge,
    "Bubble": fe.Bubble,
    "FacetBubble": fe.FacetBubble,
    "Crouzeix-Raviart": fe.CrouzeixRaviart,
    "Direct Serendipity": fe.DirectSerendipity,
    "Discontinuous Lagrange": fe.DiscontinuousLagrange,
    "Discontinuous Lagrange L2": fe.DiscontinuousLagrange,
    "Discontinuous Taylor": fe.DiscontinuousTaylor,
    "Discontinuous Raviart-Thomas": lambda *args, **kwargs:
        fe.DiscontinuousElement(fe.RaviartThomas(*args, **kwargs)),
    "DPC": fe.DPC,
    "DPC L2": fe.DPC,
    "Hermite": fe.Hermite,
    "Hsieh-Clough-Tocher": fe.HsiehCloughTocher,
    "Reduced-Hsieh-Clough-Tocher": fe.ReducedHsiehCloughTocher,
    "QuadraticPowellSabin6": fe.QuadraticPowellSabin6,
    "QuadraticPowellSabin12": fe.QuadraticPowellSabin12,
    "Alfeld-Sorokina": fe.AlfeldSorokina,
    "Arnold-Qin": fe.ArnoldQin,
    "Reduced-Arnold-Qin": fe.ReducedArnoldQin,
    "Christiansen-Hu": fe.ChristiansenHu,
    "Guzman-Neilan 1st kind H1": fe.GuzmanNeilanFirstKindH1,
    "Guzman-Neilan 2nd kind H1": fe.GuzmanNeilanSecondKindH1,
    "Guzman-Neilan H1(div)": fe.GuzmanNeilanH1div,
    "Guzman-Neilan Bubble": fe.GuzmanNeilanBubble,
    "Johnson-Mercier": fe.JohnsonMercier,
    "Lagrange": fe.Lagrange,
    "Kong-Mulder-Veldhuizen": fe.KongMulderVeldhuizen,
    "Gauss-Lobatto-Legendre": fe.GaussLobattoLegendre,
    "Gauss-Legendre": fe.GaussLegendre,
    "Gauss-Legendre L2": fe.GaussLegendre,
    "Morley": fe.Morley,
    "Nedelec 1st kind H(curl)": fe.Nedelec,
    "Nedelec 2nd kind H(curl)": fe.NedelecSecondKind,
    "Raviart-Thomas": fe.RaviartThomas,
    "Real": fe.Real,
    "S": fe.Serendipity,
    "SminusF": fe.TrimmedSerendipityFace,
    "SminusDiv": fe.TrimmedSerendipityDiv,
    "SminusE": fe.TrimmedSerendipityEdge,
    "SminusCurl": fe.TrimmedSerendipityCurl,
    "Regge": fe.Regge,
    "HDiv Trace": fe.HDivTrace,
    "Hellan-Herrmann-Johnson": fe.HellanHerrmannJohnson,
    "Gopalakrishnan-Lederer-Schoberl 1st kind":
        fe.GopalakrishnanLedererSchoberlFirstKind,
    "Gopalakrishnan-Lederer-Schoberl 2nd kind":
        fe.GopalakrishnanLedererSchoberlSecondKind,
    "Conforming Arnold-Winther": fe.ArnoldWinther,
    "Nonconforming Arnold-Winther": fe.ArnoldWintherNC,
    "Hu-Zhang": fe.HuZhang,
    "Mardal-Tai-Winther": fe.MardalTaiWinther,
    "Walkington": fe.Walkington,
    "Nonconforming Wu-Xu": fe.WuXuH3NC,
    "Nonconforming Robust Wu-Xu": fe.WuXuRobustH3NC,
    "Bramble-Zlamal C2": fe.BrambleZlamalC2,
    "Alfeld C2": fe.AlfeldC2,
    # handled specially: no direct constructor, reconstructed on
    # tensor-product cells and flattened
    "Q": None,
    "DQ": None,
    "DQ L2": None,
    "RTCE": None,
    "RTCF": None,
    "NCE": None,
    "NCF": None,
}


@cache
def as_fiat_cell(cell):
    """Convert a description cell to a concrete reference cell of
    ``core.cells``."""
    if not isinstance(cell, ufl_desc.cell.AbstractCell):
        raise ValueError("Expecting a description Cell")
    if isinstance(cell, ufl_desc.TensorProductCell):
        return core_cells.TensorProductCell(
            *map(as_fiat_cell, cell.sub_cells))
    return core_cells.ufc_cell(cell.cellname)


@singledispatch
def convert(element, **kwargs):
    """Dispatch hook converting description elements to symbolic ones.
    Do not call directly; use :func:`create_element`."""
    if element.family() in supported_elements:
        raise ValueError(
            f"Element {element} supported, but no handler provided")
    raise ValueError(f"Unsupported element type {type(element)}")


cg_interval_variants = {
    "fdm": fe.FDMLagrange,
    "fdm_ipdg": fe.FDMLagrange,
    "fdm_quadrature": fe.FDMQuadrature,
    "fdm_broken": fe.FDMBrokenH1,
    "fdm_hermite": fe.FDMHermite,
}

dg_interval_variants = {
    "fdm": fe.FDMDiscontinuousLagrange,
    "fdm_quadrature": fe.FDMDiscontinuousLagrange,
    "fdm_ipdg": lambda *args: fe.DiscontinuousElement(
        fe.FDMLagrange(*args)),
    "fdm_broken": fe.FDMBrokenL2,
}


@convert.register(ufl_desc.FiniteElement)
def convert_finiteelement(element, **kwargs):
    cell = as_fiat_cell(element.cell)
    if element.family() in {"Quadrature", "Boundary Quadrature"}:
        degree = element.degree()
        scheme = element.quadrature_scheme() or "default"
        if degree is None or scheme is None:
            raise ValueError(
                "Quadrature scheme and degree must be specified!")
        codim = 1 if element.family() == "Boundary Quadrature" else 0
        return fe.make_quadrature_element(cell, degree, scheme,
                                          codim), set()

    make_element = supported_elements[element.family()]

    if element.cell.cellname in {"quadrilateral", "hexahedron"}:
        # reconstruct Real and Bernstein on tensor-product cells
        if element.family() == "Real":
            make_element = None
            element = ufl_desc.FiniteElement("DQ", element.cell, 0)
        elif element.family() == "Bernstein":
            make_element = None

    if make_element is None:
        if element.cell.cellname == "quadrilateral":
            element = element.reconstruct(cell=quadrilateral_tpc)
        elif element.cell.cellname == "hexahedron":
            # NCF/NCE expand as quad x interval; Q/DQ as interval^3
            if element.family() in ("NCF", "NCE"):
                element = element.reconstruct(cell=hexahedron_quad_tpc)
            else:
                element = element.reconstruct(cell=hexahedron_tpc)
        else:
            raise ValueError(f"{element.family()} is supported, "
                             "but handled incorrectly")
        inner, deps = _create_element(element, **kwargs)
        return fe.FlattenedDimensions(inner), deps

    deps = set()
    finat_kwargs = {}
    kind = element.variant()
    if kind is None:
        kind = "spectral"  # default variant

    if element.family() == "Lagrange":
        if kind in ("spectral", "mimetic"):
            make_element = fe.GaussLobattoLegendre
        elif (element.cell.cellname == "interval"
                and kind in cg_interval_variants):
            make_element = cg_interval_variants[kind]
        elif any(map(kind.startswith,
                     ("integral", "demkowicz", "fdm"))):
            make_element = fe.IntegratedLegendre
            finat_kwargs["variant"] = kind
        elif kind in ("mgd", "feec", "qb", "mse"):
            make_element = fe.RuntimeTabulated
            finat_kwargs["variant"] = kind
            finat_kwargs["shift_axes"] = kwargs["shift_axes"]
            finat_kwargs["restriction"] = kwargs["restriction"]
            finat_kwargs["table_provider"] = kwargs.get("table_provider")
            deps = {"shift_axes", "restriction"}
        else:
            make_element = fe.Lagrange
            finat_kwargs["variant"] = kind

    elif element.family() in ("Discontinuous Lagrange",
                              "Discontinuous Lagrange L2"):
        if kind == "spectral":
            make_element = fe.GaussLegendre
        elif kind == "mimetic":
            make_element = fe.Histopolation
        elif (element.cell.cellname == "interval"
                and kind in dg_interval_variants):
            make_element = dg_interval_variants[kind]
        elif any(map(kind.startswith,
                     ("integral", "demkowicz", "fdm"))):
            make_element = fe.Legendre
            finat_kwargs["variant"] = kind
        elif kind in ("mgd", "feec", "qb", "mse"):
            make_element = fe.RuntimeTabulated
            finat_kwargs["variant"] = kind
            finat_kwargs["shift_axes"] = kwargs["shift_axes"]
            finat_kwargs["restriction"] = kwargs["restriction"]
            finat_kwargs["continuous"] = False
            finat_kwargs["table_provider"] = kwargs.get("table_provider")
            deps = {"shift_axes", "restriction"}
        else:
            make_element = fe.DiscontinuousLagrange
            finat_kwargs["variant"] = kind

    elif element.family() in {"HDiv Trace", "Bubble", "FacetBubble"}:
        finat_kwargs["variant"] = kind

    elif element.variant() is not None:
        finat_kwargs["variant"] = element.variant()

    if element.quadrature_scheme() is not None:
        finat_kwargs["quad_scheme"] = element.quadrature_scheme()

    return make_element(cell, element.degree(), **finat_kwargs), deps


@convert.register(ufl_desc.BrokenElement)
def convert_brokenelement(element, **kwargs):
    inner, deps = _create_element(element._element, **kwargs)
    return fe.DiscontinuousElement(inner), deps


@convert.register(ufl_desc.EnrichedElement)
def convert_enrichedelement(element, **kwargs):
    elements, deps = zip(*[_create_element(elem, **kwargs)
                           for elem in element._elements])
    return fe.EnrichedElement(elements), set.union(*deps)


@convert.register(ufl_desc.NodalEnrichedElement)
def convert_nodalenrichedelement(element, **kwargs):
    elements, deps = zip(*[_create_element(elem, **kwargs)
                           for elem in element._elements])
    return fe.NodalEnrichedElement(elements), set.union(*deps)


@convert.register(ufl_desc.MixedElement)
def convert_mixedelement(element, **kwargs):
    elements, deps = zip(*[_create_element(elem, **kwargs)
                           for elem in element.sub_elements])
    return fe.MixedElement(elements), set.union(*deps)


@convert.register(ufl_desc.VectorElement)
@convert.register(ufl_desc.TensorElement)
def convert_tensorelement(element, **kwargs):
    inner, deps = _create_element(element.sub_elements[0], **kwargs)
    shape = element.reference_value_shape
    shape = shape[:len(shape) - len(inner.value_shape)]
    shape_innermost = kwargs["shape_innermost"]
    return (fe.TensorFiniteElement(inner, shape, not shape_innermost),
            deps | {"shape_innermost"})


@convert.register(ufl_desc.TensorProductElement)
def convert_tensorproductelement(element, **kwargs):
    cell = element.cell
    if type(cell) is not ufl_desc.TensorProductCell:
        raise ValueError("TensorProductElement not on TensorProductCell?")
    shift_axes = kwargs["shift_axes"]
    dim_offset = 0
    elements = []
    deps = set()
    for elem in element.factor_elements:
        kwargs["shift_axes"] = shift_axes + dim_offset
        dim_offset += elem.cell.topological_dimension
        inner, ds = _create_element(elem, **kwargs)
        elements.append(inner)
        deps.update(ds)
    return fe.TensorProductElement(elements), deps


@convert.register(ufl_desc.HDivElement)
def convert_hdivelement(element, **kwargs):
    inner, deps = _create_element(element._element, **kwargs)
    return fe.HDivElement(inner), deps


@convert.register(ufl_desc.HCurlElement)
def convert_hcurlelement(element, **kwargs):
    inner, deps = _create_element(element._element, **kwargs)
    return fe.HCurlElement(inner), deps


@convert.register(ufl_desc.WithMapping)
def convert_withmapping(element, **kwargs):
    return _create_element(element.wrapee, **kwargs)


@convert.register(ufl_desc.RestrictedElement)
def convert_restrictedelement(element, **kwargs):
    inner, deps = _create_element(element._element, **kwargs)
    return fe.RestrictedElement(inner,
                                element.restriction_domain()), deps


hexahedron_tpc = ufl_desc.TensorProductCell(
    ufl_desc.interval, ufl_desc.interval, ufl_desc.interval)
hexahedron_quad_tpc = ufl_desc.TensorProductCell(
    ufl_desc.quadrilateral, ufl_desc.interval)
quadrilateral_tpc = ufl_desc.TensorProductCell(
    ufl_desc.interval, ufl_desc.interval)
_cache = weakref.WeakKeyDictionary()


def create_element(ufl_element, shape_innermost=True, shift_axes=0,
                   restriction=None, table_provider=None):
    """Create a tabulating element from a description element.

    :arg ufl_element: the description element
    :arg shape_innermost: vector/tensor indices after basis indices
    :arg restriction: cell restriction for interior-facet integrals
        (runtime-tabulated elements only)
    :arg table_provider: callback providing runtime tables (replaces
        FInAT's gem.Variable placeholders)
    """
    element, deps = _create_element(ufl_element,
                                    shape_innermost=shape_innermost,
                                    shift_axes=shift_axes,
                                    restriction=restriction,
                                    table_provider=table_provider)
    return element


def _create_element(ufl_element, **kwargs):
    """Caching wrapper around :func:`convert`: remembers which kwargs
    each description actually depended on."""
    try:
        cache = _cache[ufl_element]
    except KeyError:
        _cache[ufl_element] = {}
        cache = _cache[ufl_element]

    for key, element in cache.items():
        if all(kwargs[param] == value for param, value in key):
            return element, set(param for param, value in key)

    if ufl_element.cell is None:
        raise ValueError(
            "Don't know how to build element when cell is not given")

    element, deps = convert(ufl_element, **kwargs)
    key = frozenset((param, kwargs[param]) for param in deps)
    cache[key] = element
    return element, deps


def create_base_element(ufl_element, **kwargs):
    """Create the underlying scalar element of a description element."""
    element = create_element(ufl_element, **kwargs)
    if isinstance(element, fe.TensorFiniteElement):
        element = element.base_element
    return element
