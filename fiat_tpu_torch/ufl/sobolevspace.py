"""Sobolev space lattice for element descriptions.

Self-contained equivalent of ``ufl.sobolevspace`` (imported by FInAT's
finat/ufl/elementlist.py; the port's copy of ``fiat_tpu.ufl.sobolevspace``).
Spaces are partially ordered
by inclusion of the function sets: H2 is a subset of H1 is a subset of
L2, so ``H2 < H1 < L2`` and ``max(...)`` picks the weakest (largest)
space -- the semantics MixedElement relies on."""

import functools


@functools.total_ordering
class SobolevSpace:
    """A named space in the smoothness lattice."""

    def __init__(self, name, parents=None, order=0):
        self.name = name
        # transitive set of strictly larger spaces (weaker smoothness)
        self.parents = frozenset(parents or ())
        self._order = order

    def __repr__(self):
        return f"SobolevSpace({self.name!r})"

    def __str__(self):
        return self.name

    def __eq__(self, other):
        return (isinstance(other, SobolevSpace)
                and self.name == other.name)

    def __hash__(self):
        return hash(("SobolevSpace", self.name))

    def __lt__(self, other):
        """``self < other``: self is a proper subset of other."""
        return other in self.parents

    def __contains__(self, element):
        """An element is in the space if its space is this or stronger."""
        ss = element.sobolev_space
        return ss == self or self in ss.parents

    def __call__(self, element):
        """HDiv(element) / HCurl(element) build conforming wrappers."""
        if self.name == "HDiv":
            from .hdivcurl import HDivElement
            return HDivElement(element)
        elif self.name == "HCurl":
            from .hdivcurl import HCurlElement
            return HCurlElement(element)
        raise NotImplementedError(
            "Only the HDiv and HCurl spaces are callable.")


class DirectionalSobolevSpace(SobolevSpace):
    """Smoothness varying by spatial direction (tensor-product
    elements with mixed-continuity factors)."""

    def __init__(self, orders):
        self._orders = tuple(orders)
        name = "DirectionalH(" + ", ".join(map(str, self._orders)) + ")"
        parents = {L2} if min(self._orders, default=0) >= 0 else set()
        super().__init__(name, parents, order=min(self._orders, default=0))

    @property
    def orders(self):
        return self._orders

    def __getitem__(self, i):
        order = self._orders[i]
        for space in (L2, H1, H2, H3):
            if space._order == order:
                return space
        return self


L2 = SobolevSpace("L2", order=0)
HDiv = SobolevSpace("HDiv", {L2}, order=0)
HCurl = SobolevSpace("HCurl", {L2}, order=0)
HEin = SobolevSpace("HEin", {L2}, order=0)
HDivDiv = SobolevSpace("HDivDiv", {L2}, order=0)
HCurlDiv = SobolevSpace("HCurlDiv", {L2}, order=0)
H1 = SobolevSpace("H1", {L2, HDiv, HCurl}, order=1)
H2 = SobolevSpace("H2", {H1, L2, HDiv, HCurl}, order=2)
H3 = SobolevSpace("H3", {H2, H1, L2, HDiv, HCurl}, order=3)
HInf = SobolevSpace("HInf", {H3, H2, H1, L2, HDiv, HCurl},
                    order=float("inf"))
