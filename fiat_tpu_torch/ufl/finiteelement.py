"""The FiniteElement description class.

FInAT's finat/ufl/finiteelement.py (the port's copy of
``fiat_tpu.ufl.finiteelement``): the simple
element description, with __new__ expanding tensor-product families
(RTCF/RTCE/NCF/NCE/Q/DQ/Real/Bernstein) into compositions on
TensorProductCells."""

from .cell import TensorProductCell, as_cell
from .elementlist import canonical_element_description, simplices
from .finiteelementbase import FiniteElementBase, istr


class FiniteElement(FiniteElementBase):
    """The basic finite element description."""

    def __new__(cls, family, cell=None, degree=None, form_degree=None,
                quad_scheme=None, variant=None):
        """Expand product families when constructed on a product cell."""
        if cell is not None:
            cell = as_cell(cell)

        if isinstance(cell, TensorProductCell):
            from .enrichedelement import EnrichedElement
            from .hdivcurl import HCurlElement as HCurl
            from .hdivcurl import HDivElement as HDiv
            from .tensorproductelement import TensorProductElement

            (family, short_name, degree, reference_value_shape,
             sobolev_space, mapping, embedded_degree) = \
                canonical_element_description(family, cell, degree,
                                              form_degree)

            if family in ("RTCF", "RTCE"):
                cell_h, cell_v = cell.sub_cells
                if (cell_h.cellname != "interval"
                        or cell_v.cellname != "interval"):
                    raise ValueError(
                        f"{family} needs TensorProductCell"
                        "(interval, interval).")
                C = FiniteElement("CG", "interval", degree, variant=variant)
                D = FiniteElement("DG", "interval", degree - 1,
                                  variant=variant)
                CxD = TensorProductElement(C, D, cell=cell)
                DxC = TensorProductElement(D, C, cell=cell)
                wrap = HDiv if family == "RTCF" else HCurl
                return EnrichedElement(wrap(CxD), wrap(DxC))

            elif family in ("NCF", "NCE"):
                cell_h, cell_v = cell.sub_cells
                if (cell_h.cellname != "quadrilateral"
                        or cell_v.cellname != "interval"):
                    raise ValueError(
                        f"{family} needs TensorProductCell"
                        "(quadrilateral, interval).")
                Ic = FiniteElement("CG", "interval", degree,
                                   variant=variant)
                Id = FiniteElement("DG", "interval", degree - 1,
                                   variant=variant)
                if family == "NCF":
                    Qc = FiniteElement("RTCF", "quadrilateral", degree,
                                       variant=variant)
                    Qd = FiniteElement("DQ", "quadrilateral", degree - 1,
                                       variant=variant)
                    return EnrichedElement(
                        HDiv(TensorProductElement(Qc, Id, cell=cell)),
                        HDiv(TensorProductElement(Qd, Ic, cell=cell)))
                else:
                    Qc = FiniteElement("Q", "quadrilateral", degree,
                                       variant=variant)
                    Qd = FiniteElement("RTCE", "quadrilateral", degree,
                                       variant=variant)
                    return EnrichedElement(
                        HCurl(TensorProductElement(Qc, Id, cell=cell)),
                        HCurl(TensorProductElement(Qd, Ic, cell=cell)))

            elif family in ("Q", "Bernstein"):
                if family == "Q":
                    family = "CG"
                return TensorProductElement(
                    *[FiniteElement(family, c, degree, variant=variant)
                      for c in cell.sub_cells], cell=cell)

            elif family == "DQ":
                def dq_family(c):
                    return "DG" if c.cellname in simplices else "DQ"
                return TensorProductElement(
                    *[FiniteElement(dq_family(c), c, degree,
                                    variant=variant)
                      for c in cell.sub_cells], cell=cell)

            elif family == "DQ L2":
                def dq_family_l2(c):
                    return ("DG L2" if c.cellname in simplices
                            else "DQ L2")
                return TensorProductElement(
                    *[FiniteElement(dq_family_l2(c), c, degree,
                                    variant=variant)
                      for c in cell.sub_cells], cell=cell)

            elif family == "Real":
                return TensorProductElement(
                    *[FiniteElement("Real", c, degree, variant=variant)
                      for c in cell.sub_cells], cell=cell)

        return super().__new__(cls)

    def __init__(self, family, cell=None, degree=None, form_degree=None,
                 quad_scheme=None, variant=None):
        """Create a finite element description.

        :arg family: element family name (or short name / alias)
        :arg cell: the cell (name or Cell)
        :arg degree: polynomial degree
        :arg form_degree: FEEC form degree (k for k-forms)
        :arg quad_scheme: quadrature scheme hint
        :arg variant: basis variant hint
        """
        if cell is not None:
            cell = as_cell(cell)

        (family, short_name, degree, reference_value_shape, sobolev_space,
         mapping, embedded_degree) = canonical_element_description(
             family, cell, degree, form_degree)

        self._sobolev_space = sobolev_space
        self._mapping = mapping
        self._short_name = short_name or family
        self._variant = variant
        self._embedded_degree = embedded_degree

        if variant is not None and not isinstance(variant, str):
            raise ValueError("Illegal variant: must be string or None")

        FiniteElementBase.__init__(self, family, cell, degree, quad_scheme,
                                   reference_value_shape)

        quad_str = ("" if quad_scheme is None
                    else f", quad_scheme={quad_scheme!r}")
        var_str = "" if variant is None else f", variant={variant!r}"
        self._repr = (f"FiniteElement({self.family()!r}, {self.cell!r}, "
                      f"{self.degree()!r}{quad_str}{var_str})")

    def __repr__(self):
        return self._repr

    def _is_globally_constant(self):
        return self.family() == "Real"

    def _is_linear(self):
        return self.family() == "Lagrange" and self.degree() == 1

    def mapping(self):
        return self._mapping

    @property
    def sobolev_space(self):
        return self._sobolev_space

    def variant(self):
        return self._variant

    def reconstruct(self, family=None, cell=None, degree=None,
                    quad_scheme=None, variant=None):
        """Copy with some properties replaced."""
        return FiniteElement(
            family if family is not None else self.family(),
            cell if cell is not None else self.cell,
            degree if degree is not None else self.degree(),
            quad_scheme=(quad_scheme if quad_scheme is not None
                         else self.quadrature_scheme()),
            variant=variant if variant is not None else self.variant())

    def __str__(self):
        qs = self.quadrature_scheme()
        qs = "" if qs is None else f"({qs})"
        v = self.variant()
        v = "" if v is None else f"({v})"
        return (f"<{self._short_name}{istr(self.degree())}{qs}{v} "
                f"on a {self.cell}>")

    def shortstr(self):
        return (f"{self._short_name}{istr(self.degree())}"
                f"({self.quadrature_scheme()},{istr(self.variant())})")

    def __getnewargs__(self):
        return (self.family(), self.cell, self.degree(), None,
                self.quadrature_scheme(), self.variant())

    @property
    def embedded_subdegree(self):
        sub = self.degree()
        if not isinstance(sub, int):
            sub = min(sub)
        if isinstance(self._embedded_degree, int):
            sub = min(sub, self._embedded_degree)
        return sub

    @property
    def embedded_superdegree(self):
        sup = self.degree()
        if not isinstance(sup, int):
            sup = max(sup)
        if isinstance(self._embedded_degree, int):
            sup = max(sup, self._embedded_degree)
        return sup
