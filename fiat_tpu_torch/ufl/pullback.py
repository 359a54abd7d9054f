"""Pullback vocabulary for element descriptions.

Self-contained equivalent of ``ufl.pullback`` (FInAT's
description classes expose a ``pullback`` property mapping to these
singletons; finat/ufl/finiteelementbase.py:24-34).  Each pullback knows
the physical value shape it induces; the actual reference-to-physical
transformation math lives in the symbolic layer
(``fiat_tpu_torch.symbolic.physically_mapped``).  The port's copy of
``fiat_tpu.ufl.pullback``."""


class AbstractPullback:
    name = "abstract"

    def __repr__(self):
        return type(self).__name__ + "()"

    def __eq__(self, other):
        return type(self) is type(other)

    def __hash__(self):
        return hash(type(self).__name__)

    def physical_value_shape(self, element, domain=None):
        return element.reference_value_shape


class IdentityPullback(AbstractPullback):
    name = "identity"


class L2Piola(AbstractPullback):
    name = "L2 Piola"


class CustomPullback(AbstractPullback):
    name = "custom"


class PhysicalPullback(AbstractPullback):
    name = "physical"


class CovariantPiola(AbstractPullback):
    name = "covariant Piola"

    def physical_value_shape(self, element, domain=None):
        return (element.cell.topological_dimension,)


class ContravariantPiola(CovariantPiola):
    name = "contravariant Piola"


class DoubleCovariantPiola(AbstractPullback):
    name = "double covariant Piola"

    def physical_value_shape(self, element, domain=None):
        d = element.cell.topological_dimension
        return (d, d)


class DoubleContravariantPiola(DoubleCovariantPiola):
    name = "double contravariant Piola"


class CovariantContravariantPiola(DoubleCovariantPiola):
    name = "covariant contravariant Piola"


class MixedPullback(AbstractPullback):
    name = "mixed"

    def __init__(self, element):
        self._element = element

    def physical_value_shape(self, element, domain=None):
        return (sum(e.value_size(domain)
                    for e in self._element.sub_elements),)


class SymmetricPullback(AbstractPullback):
    name = "symmetries"

    def __init__(self, element, symmetry):
        self._element = element
        self._symmetry = symmetry

    def physical_value_shape(self, element, domain=None):
        return element._shape + element.sub_elements[0].value_shape(domain)


identity_pullback = IdentityPullback()
l2_piola = L2Piola()
covariant_piola = CovariantPiola()
contravariant_piola = ContravariantPiola()
double_covariant_piola = DoubleCovariantPiola()
double_contravariant_piola = DoubleContravariantPiola()
covariant_contravariant_piola = CovariantContravariantPiola()
custom_pullback = CustomPullback()
physical_pullback = PhysicalPullback()

#: mapping name -> pullback singleton (reference:
#: finat/ufl/finiteelementbase.py:24)
supported_pullbacks = {
    "identity": identity_pullback,
    "L2 Piola": l2_piola,
    "covariant Piola": covariant_piola,
    "contravariant Piola": contravariant_piola,
    "double covariant Piola": double_covariant_piola,
    "double contravariant Piola": double_contravariant_piola,
    "covariant contravariant Piola": covariant_contravariant_piola,
    "custom": custom_pullback,
    "physical": physical_pullback,
    "undefined": identity_pullback,
}
