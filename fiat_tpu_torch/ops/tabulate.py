"""The batched tabulation engine for a zoo of elements.

Counterpart of ``fiat_tpu/ops/tabulate.py`` (``change_of_basis``,
``MacroSideProgram`` and ``BatchedTabulator`` with ``matmul="native"``).
Every plain element's coefficients are re-expressed in the orthonormal
Dubiner basis of the zoo's maximum degree (lower-degree bases are prefixes
of higher-degree ones in morton order) and stacked.  With
``derivs="dmats"`` (the default) the stack is multiplied by one
change-of-basis matrix per derivative multi-index, so the plain part of a
pass is ONE value recurrence plus one matrix product per multi-index;
with ``derivs="jets"`` the one stack multiplies every derivative table of
the recurrence run on Taylor jets.  Macro elements (bases on split
complexes) become ``MacroSideProgram``s: one tall matrix over the masked
parent-cell basis (under jets past order 0, as in fiat_tpu, each macro
element tabulates its own split expansion instead).

The engine here runs in plain PyTorch on the points' device; the kernel
engine is ``fused_zoo.FusedZooTabulator``, which takes the same host-built
arrays (``state``).
"""

import copy

import numpy as np
import torch

from ..core import cells as cl
from ..core import expansions
from .kernels import resolve_device


def change_of_basis(expansion_set, degree, target_expansion_set, target_degree):
    """T with phi_src_i = sum_j T[i, j] phi_tgt_j, by collocation at a
    Gauss-Legendre lattice (exact: both bases span subsets of P_target)."""
    ref_el = expansion_set.ref_el
    pts = cl.make_lattice(ref_el.get_vertices(), target_degree, variant="gl")
    src = expansion_set.tabulate(degree, pts)                 # (m_src, npts)
    tgt = target_expansion_set.tabulate(target_degree, pts)   # (m_tgt, npts)
    return np.linalg.solve(tgt.T, src.T).T                    # (m_src, m_tgt)


class MacroSideProgram:
    """Batched tabulation of macro (split-complex) elements sharing one
    expansion set and degree, in the dmats form.

    Per subcell c the macro basis rows supported on c restrict to the
    cell's polynomial basis Phi_c, which extends polynomially to the whole
    parent cell, so Phi_c = T_c @ Phi_parent exactly.  Every derivative
    table therefore reads

      D^alpha table = sum_c (flat[:, nodes_c] D_c^alphaT T_c) @ (mask_c * Phi)

    with Phi the PARENT-cell orthonormal tabulation, computed once per pass,
    and one tall matrix (``tall``, alpha-major, element-minor rows; one
    ``nexp_parent``-wide column block per subcell) covering all member
    elements and derivative multi-indices."""

    def __init__(self, es, degree, members, alphas):
        """:arg members: [(element_index, flat_coeffs (rows_e, num_phis))]
        :arg alphas: derivative multi-indices (the (0,..,0) value entry
        first).

        A program of embedded degree 0 (DG 0, Regge 0 or HHJ 0 on a split)
        raises ``NotImplementedError``: fiat_tpu collocates the subcell
        basis on a degree-max(degree, 1) lattice against the degree-0
        parent basis, a non-square solve that fails there with a
        ``LinAlgError`` (``fiat_tpu/ops/tabulate.py:181-187``), so neither
        package's engines take it; such an element tabulates on the host."""
        if degree == 0:
            raise NotImplementedError(
                f"MacroSideProgram: a macro program of embedded degree 0 on "
                f"{type(es.ref_el).__name__}; fiat_tpu's engine collocates it on a degree-1 "
                "lattice against the one-member parent basis (a non-square solve, "
                "fiat_tpu/ops/tabulate.py:181-187), so no engine runs it: tabulate such an "
                "element on the host")
        self.es = es
        self.degree = degree
        self.alphas = list(alphas)
        sd = es.ref_el.get_spatial_dimension()
        self.cells = sorted(es.ref_el.get_topology()[sd])
        cnm = es.get_cell_node_map(degree)

        parent = es.ref_el.get_parent()
        self.parent_es = expansions.ExpansionSet(parent)
        self.nexp_parent = self.parent_es.get_num_members(degree)
        # subcell basis -> parent basis by collocation at a GL lattice
        lat = cl.make_lattice(parent.get_vertices(), max(degree, 1), variant="gl")
        tgt = self.parent_es.tabulate(degree, lat)
        T = {}
        for c in self.cells:
            src = es._tabulate_on_cell(degree, np.asarray(lat), order=0, cell=c)[(0,) * sd]
            T[c] = np.linalg.solve(tgt.T, np.asarray(src).T).T

        blocks = {a: [] for a in self.alphas}
        self.row_slices = []
        cursor = 0
        for idx, flat in members:
            for alpha in self.alphas:
                row = []
                for c in self.cells:
                    M = flat[:, cnm[c]]
                    D = es.get_dmats(degree, cell=c)
                    for k, ak in enumerate(alpha):
                        for _ in range(ak):
                            M = M @ np.transpose(D[k])
                    row.append(M @ T[c])
                blocks[alpha].append(np.hstack(row))
            self.row_slices.append((idx, cursor, cursor + flat.shape[0]))
            cursor += flat.shape[0]
        self.rows = cursor
        # (nalpha * rows, ncells * nexp_parent): alpha-major, element-minor
        self.tall = np.vstack([np.vstack(blocks[a]) for a in self.alphas])
        self.K = self.tall.shape[1]

    def b_stack(self, pts, order):
        """Stacked masked parent tabulation (ncells * nexp_parent, npts) on
        the points' device: unique binning for a C0 basis at order 0,
        averaged multiplicities otherwise."""
        unique = self.es.continuity is not None and order == 0
        masks = expansions.partition_of_unity_masks(self.es.ref_el, pts, unique=unique)
        phi = self.parent_es._tabulate_on_cell(self.degree, pts)[(0,) * pts.shape[-1]]
        return torch.cat([m * phi for m in masks], dim=0)

    def tables(self, pts, order):
        """{alpha: (rows, npts)} via one tall matrix product."""
        out = pts.new_tensor(self.tall) @ self.b_stack(pts, order)
        r = self.rows
        return {a: out[k * r:(k + 1) * r] for k, a in enumerate(self.alphas)}


def rebase_program(program, parent_es):
    """A copy of a macro side program (the port's or fiat_tpu's) whose
    ``tall`` matrix multiplies another basis of the same parent
    polynomials, ``parent_es`` (another scale, cell map or variant): each
    subcell's column block of ``tall`` times T, phi_old = T phi_new, by
    collocation at a Gauss-Legendre lattice of the parent (exact: both
    bases span the parent's polynomials of the program's degree).  The
    tables are the same; the engines take the new parent's route.  A
    checking utility: no path of the package calls it; the tests and
    ``chip_smoke.py`` use it to reach the per-program routes."""
    out = copy.copy(program)
    parent = program.es.ref_el.get_parent()
    lat = cl.make_lattice(parent.get_vertices(), max(program.degree, 1), variant="gl")
    old = np.asarray(program.parent_es.tabulate(program.degree, lat))
    new = np.asarray(parent_es.tabulate(program.degree, lat))
    T = np.linalg.solve(new.T, old.T).T
    n = program.nexp_parent
    tall = np.array(program.tall, dtype=np.float64)
    for c in range(len(program.cells)):
        tall[:, c * n:(c + 1) * n] = tall[:, c * n:(c + 1) * n] @ T
    out.parent_es, out.tall = parent_es, tall
    return out


class BatchedTabulator:
    """Tabulate a whole zoo of nodal elements (same reference cell) in one
    program: ``tables = bt(points)`` gives {alpha: (rows, npts)} (the plain
    elements' rows first, then the macro elements'), and
    ``bt.unpack(tables)`` the per-element dicts of ``el.tabulate``.

    ``device``: where ``bt(points)`` and the moments functions run; the
    CUDA card when None (raising without one), the CPU only where asked.
    The kernel engines take the host arrays (``state()``) and their own
    ``device``.

    ``derivs``: "dmats" (derivative tables as change-of-basis rows on the
    order-0 recurrence) or "jets" (the recurrence on Taylor jets, one
    change of basis for every table; ``alpha_mats`` stays empty, and past
    order 0 ``macro_programs`` too, as in fiat_tpu)."""

    def __init__(self, elements, order=0, device=None, derivs="dmats"):
        if derivs not in ("dmats", "jets"):
            raise ValueError(f"derivs {derivs!r}: 'dmats' or 'jets'")
        self.derivs = derivs
        cells = {e.get_reference_element() for e in elements}
        if len(cells) != 1:
            raise ValueError("BatchedTabulator needs a common reference cell")
        self.ref_el, = cells
        if not all(getattr(e, "is_nodal", lambda: False)() for e in elements):
            raise NotImplementedError("BatchedTabulator fuses nodal (Ciarlet) bases")
        self.elements = list(elements)
        self.order = order
        self.device = resolve_device(device)
        self.sd = self.ref_el.get_spatial_dimension()

        # plain elements share the fused change of basis; macro elements
        # (split-complex expansions) become side programs
        plain = [e for e in self.elements if not e.is_macroelement()]
        self.special = [(i, e) for i, e in enumerate(self.elements) if e.is_macroelement()]
        if not plain:
            raise ValueError("BatchedTabulator needs at least one non-macro element")

        self.max_degree = max(e.get_nodal_basis().get_embedded_degree() for e in plain)
        self.target_es = _target_expansion_set(self.ref_el, plain)
        nexp = self.target_es.get_num_members(self.max_degree)

        blocks = []
        plain_slices = {}
        #: element index -> leading target-basis columns its rows can touch
        #: (a degree-d basis lives in the degree-d morton prefix)
        self.plain_nexp = {}
        cursor = 0
        for i, e in enumerate(self.elements):
            if e.is_macroelement():
                continue
            ps = e.get_nodal_basis()
            es = ps.get_expansion_set()
            deg = ps.get_embedded_degree()
            self.plain_nexp[i] = self.target_es.get_num_members(deg)
            coeffs = np.asarray(ps.get_coeffs())
            if (type(es) is type(self.target_es) and es.variant is None
                    and es.ref_el == self.target_es.ref_el):
                # plain Dubiner: prefix embedding, zero-padded, up to the
                # degree-dependent normalisation (1 at degree 0)
                ratio = float(es.get_scale(deg)) / float(self.target_es.get_scale(self.max_degree))
                T = np.zeros((coeffs.shape[-1], nexp))
                T[:, :coeffs.shape[-1]] = ratio * np.eye(coeffs.shape[-1])
            else:
                T = change_of_basis(es, deg, self.target_es, self.max_degree)
            flat = coeffs.reshape(-1, coeffs.shape[-1]) @ T
            blocks.append(flat)
            plain_slices[i] = (cursor, cursor + flat.shape[0], coeffs.shape[:-1])
            cursor += flat.shape[0]
        self.stacked = np.vstack(blocks)          # (plain_rows, nexp)

        # macro side programs: (expansion set, degree, flat coeffs)
        self.special_progs = []
        special_slices = {}
        for i, e in self.special:
            ps = e.get_nodal_basis()
            coeffs = np.asarray(ps.get_coeffs())
            flat = coeffs.reshape(-1, coeffs.shape[-1])
            self.special_progs.append((ps.get_expansion_set(), ps.get_embedded_degree(), flat))
            special_slices[i] = (cursor, cursor + flat.shape[0], coeffs.shape[:-1])
            cursor += flat.shape[0]
        self.slices = [plain_slices.get(i) or special_slices[i]
                       for i in range(len(self.elements))]

        # one change-of-basis matrix per derivative multi-index:
        # D^alpha phi = (prod_k dmats[k]^T^alpha_k) @ phi
        self.alpha_mats = {}
        if self.order > 0 and derivs == "dmats":
            D = self.target_es.get_dmats(self.max_degree)
            for alpha in expansions.multiindices(self.sd, self.order):
                M = self.stacked
                for k, ak in enumerate(alpha):
                    for _ in range(ak):
                        M = M @ np.transpose(D[k])
                self.alpha_mats[alpha] = M
        mats = self.alpha_mats or {(0,) * self.sd: self.stacked}
        self._mats = {a: torch.as_tensor(M, device=self.device) for a, M in mats.items()}

        self._stacked_t = torch.as_tensor(self.stacked, device=self.device)

        # one tall program per group of macro elements sharing an expansion
        # set; under jets past order 0 none (fiat_tpu's special_progs route)
        self.macro_programs = []
        if derivs == "dmats" or order == 0:
            self.macro_programs = self._programs(list(mats))
        self._value_programs = None

    def _programs(self, alphas):
        """The macro side programs over the derivative multi-indices
        ``alphas``."""
        groups = {}
        for (i, e), (es, deg, flat) in zip(self.special, self.special_progs):
            groups.setdefault((id(es), deg), (es, deg, []))[2].append((i, flat))
        return [MacroSideProgram(es, deg, members, alphas) for es, deg, members in groups.values()]

    def engine_programs(self):
        """The macro programs the kernel engines take (``state()``): the
        tabulator's own, or under jets past order 0, where it has none,
        programs of the value table alone, which is all fiat_tpu's engines
        key there."""
        if self.macro_programs or not self.special:
            return self.macro_programs
        if self._value_programs is None:
            self._value_programs = self._programs([(0,) * self.sd])
        return self._value_programs

    def state(self):
        """The host-built arrays that define the engine (see
        ``fused_zoo.FusedZooTabulator.from_arrays``)."""
        return dict(stacked=self.stacked, alpha_mats=self.alpha_mats,
                    slices=self.slices, plain_nexp=self.plain_nexp,
                    max_degree=self.max_degree,
                    scale=float(self.target_es.get_scale(self.max_degree)),
                    affine_map=self.target_es.affine_mappings[0],
                    macro_programs=self.engine_programs())

    def __call__(self, points):
        """{alpha: (total_rows, npts)} fused tables, in float64 on the
        engine's device."""
        pts = torch.as_tensor(points, dtype=torch.float64, device=self.device)
        if self.alpha_mats:
            phi = self.target_es._tabulate_on_cell(self.max_degree, pts)[(0,) * self.sd]
            parts = {a: [M @ phi] for a, M in self._mats.items()}
        else:
            # jets (or order 0): one change of basis on every table of the
            # recurrence
            base = self.target_es._tabulate_on_cell(self.max_degree, pts, order=self.order)
            parts = {a: [self._stacked_t @ tab] for a, tab in base.items()}
        per_elem = {}
        for prog in self.macro_programs:
            tabs = prog.tables(pts, self.order)
            for idx, lo, hi in prog.row_slices:
                per_elem[idx] = {a: t[lo:hi] for a, t in tabs.items()}
        if self.special and not self.macro_programs:
            # jets past order 0: each macro element tabulates its own split
            # expansion (fiat_tpu's special_progs route)
            for (i, _), (es, deg, flat) in zip(self.special, self.special_progs):
                base = es._tabulate(deg, pts, order=self.order)
                C = pts.new_tensor(flat)
                per_elem[i] = {a: C @ base[a] for a in parts}
        for i, _ in self.special:
            for a in parts:
                parts[a].append(per_elem[i][a])
        return {a: torch.cat(blocks, dim=0) for a, blocks in parts.items()}

    def unpack(self, tables):
        """Split fused tables back into the per-element layout."""
        return [{a: tab[lo:hi].reshape(tuple(shape) + tuple(tab.shape[-1:]))
                 for a, tab in tables.items()}
                for lo, hi, shape in self.slices]


class ElementTabulator:
    """One element's tables {alpha: (rows..., npts)} on the kernel engine:
    ``tab = ElementTabulator(element, order); tables = tab(points)`` gives
    what ``element.tabulate(order, points)`` gives, in float64 on
    ``device``.

    Counterpart of fiat_tpu's ``ElementTabulator`` ("the element's
    expansion recurrence and its change-of-basis product"): a zoo of one
    element on the f64 kernel engine, ``device_tabulator([element],
    order)`` -- K1 (the Dubiner recurrence) and K2 (the change-of-basis
    product), one launch each a call -- on the CUDA card when ``device`` is
    None (raising without one), the kernels' plain versions where the caller
    asks for the CPU.  ``recurrence`` (K1) and ``matmul`` (K2) carry the
    launch counts.  fiat_tpu's TPU-only keywords (``tile``, ``matmul``,
    ``wdtype``, ``interpret``: ``TPU_ONLY``) are taken and ignored, as by
    ``device_tabulator``; any other is a ``TypeError``.  Its point tiling
    (``adaptive_tile``, ``lax.map``) has no counterpart.

    An element on a quadrilateral or hexahedron whose nodal basis is a
    plain Dubiner set on an embedded simplex (DPC, as fiat_tpu's
    ``ElementTabulator`` evaluates it) runs the same engine on that
    simplex's expansion set: K1 evaluates its polynomials at the cell's
    points, which the simplex need not contain.

    Where the engine does not apply it raises ``NotImplementedError``
    naming the case, never a slower engine: a macro element (the engine
    fuses macro elements only beside a plain one, as
    ``BatchedTabulator``), an element without a nodal expansion basis, any
    other element on a cell other than the interval, the triangle and the
    tetrahedron.  A basis of any width runs: past 792 members (the
    tetrahedron past degree 14) K2 streams Phi in k."""

    def __init__(self, element, order=0, device=None, **tpu_only):
        from . import TPU_ONLY, device_tabulator
        unknown = sorted(set(tpu_only) - set(TPU_ONLY))
        if unknown:
            raise TypeError(f"ElementTabulator() got unexpected keyword arguments {unknown}")
        name = type(element).__name__
        ref_el = element.get_reference_element()
        simplex = ref_el.get_shape() in (cl.LINE, cl.TRIANGLE, cl.TETRAHEDRON)
        if not simplex and _embedded_dubiner(element) is None:
            raise NotImplementedError(
                f"ElementTabulator: {name} on {type(ref_el).__name__}; the kernel engine "
                "covers the interval, the triangle and the tetrahedron, and on other cells a "
                "nodal basis on an embedded simplex (DPC)")
        if element.is_macroelement():
            raise NotImplementedError(
                f"ElementTabulator: {name} is a macro element; the kernel engine takes macro "
                "elements only in a zoo with a plain element (BatchedTabulator, "
                "device_tabulator)")
        try:
            element.get_nodal_basis().get_embedded_degree()
        except (AttributeError, NotImplementedError):
            raise NotImplementedError(
                f"ElementTabulator: {name} has no nodal expansion basis for the kernel "
                "engine's change of basis") from None
        self.element = element
        self.order = order
        self.engine = device_tabulator([element], order=order, device=device)
        self.device = self.engine.device

    @property
    def recurrence(self):
        """K1's wrapper (its ``launches``)."""
        return self.engine.recurrence

    @property
    def matmul(self):
        """K2's wrapper (its ``launches``)."""
        return self.engine.matmul

    def __call__(self, points):
        """{alpha: float64 tensor (rows..., npts)} at ``points`` (npts, sd):
        host points go to the engine's device; a tensor must be there."""
        return self.engine.unpack(self.engine.block_tables(points))[0]


def _embedded_dubiner(element):
    """The expansion set of ``element``'s nodal basis where it is a plain
    Dubiner set on a simplex (the interval, triangle or tetrahedron) of the
    element's dimension, as DPC's on a quadrilateral or hexahedron; else
    None."""
    try:
        es = element.get_nodal_basis().get_expansion_set()
    except (AttributeError, NotImplementedError):
        return None
    if (type(es) not in (expansions.LineExpansionSet, expansions.TriangleExpansionSet,
                         expansions.TetrahedronExpansionSet)
            or es.variant is not None or es.ref_el.is_macrocell()
            or es.ref_el.get_spatial_dimension()
            != element.get_reference_element().get_spatial_dimension()):
        return None
    return es



def _target_expansion_set(ref_el, plain):
    """The Dubiner set a zoo's rows are fused on: the cell's own on a
    simplex; on another cell the set the ``plain`` elements' nodal bases
    share where each is a plain Dubiner set on one simplex of the cell's
    dimension (DPC's on a quadrilateral or hexahedron: K1 evaluates its
    polynomials at the cell's points, which the simplex need not
    contain); else the cell's own, which raises."""
    if not ref_el.is_simplex():
        sets = [_embedded_dubiner(e) for e in plain]
        if all(es is not None and es.ref_el == sets[0].ref_el for es in sets):
            return expansions.ExpansionSet(sets[0].ref_el)
    return expansions.ExpansionSet(ref_el)
