#!/usr/bin/env python3
"""Smoke run of fiat_tpu_torch on one CUDA card.

Drives the port's main paths once each at their real size, at 1e5 points
(bench.py's ``pts2``, seed 42), through the entry points a user calls:

  1. the nodal slice: Lagrange 1-10 + DiscontinuousLagrange 1-8,
     ``device_tabulator(..., order=1, device="cuda").block_tables`` (K1, K2);
  2. ``full_zoo`` (bench.py:840-862), the 42 triangle elements: the slice
     plus RT, Nedelec and BDM 1-6, CubicHermite, Morley, Argyris, Bell,
     and the macro elements HsiehCloughTocher 3 and QuadraticPowellSabin6,
     the same call in float64 (K1, K2, K3; K7 on K3's arrays and K1's Phi
     held against K3 and timed beside it);
  3. ``moments_interp_full_zoo`` (bench.py:864-879): dual evaluation of
     ``full_zoo`` through ``ops.moments`` on a
     ``BatchedTabulator(full_zoo, order=0, device="cuda")``: ``moment_rows``
     (K45, also timed at 1e7 points) and ``interpolate_rows`` (K1, and K3
     on one row per program, timed);
  4. ``full_zoo`` on the f32 engine,
     ``device_tabulator(..., order=1, f64=False, device="cuda").tables``
     (K6, K3 in float32), held against phase 2's float64 tables;
  5. tetrahedra at bench.py's ``pts3`` (seed 42, drawn after ``pts2``):
     ``tet_lagrange8`` (bench.py:793-795) through ``device_tabulator(...,
     order=1)`` on the default device (K1's sd = 3 stage, K2 at contraction
     width 165) and through ``FusedZooTabulator(BatchedTabulator(...),
     features="bernstein")`` (K8 + K2), and ``hdiv_hcurl_tet``
     (bench.py:809-818: RT, Nedelec and BDM 1-3, K1 + K2);
  6. ``sv_macro_tet`` at ``pts3``: the Scott-Vogelius pairs on barycentrically
     refined tetrahedra (Lagrange 1 and 3, Lagrange 3 + DG 2 on the Alfeld
     split, Lagrange 2 + DG 1 on the Worsey-Farin split) through
     ``device_tabulator(..., order=1)`` on the default device: K1 (sd = 3),
     K2 and K7, the macro elements on K7 reading K1's Phi by prefix; then
     Lagrange 1 + DiscontinuousLagrange 6 on the Worsey-Farin split, whose
     K7 row chunks (274,176 bytes) pass a block's shared memory, on K1, K2
     and K7 once each;
  7. tetrahedra through dual evaluation and the f32 engine, at ``pts3``:
     ``ops.moments.moment_rows`` and ``interpolate_rows`` on a
     ``BatchedTabulator(zoo, order=0)`` on the default device for
     ``tet_lagrange8`` and ``hdiv_hcurl_tet`` (moments on K45's sd = 3
     stage, interpolation on K1 and no K45), ``moment_rows`` on
     ``sv_macro_tet`` (K45 alone: 308 sums over 32 subcells, no K3), K45
     alone on ``tet_lagrange8`` at 1e7 points, and
     ``device_tabulator(..., order=1, f64=False).tables`` for
     ``tet_lagrange8`` and ``hdiv_hcurl_tet`` (K6's sd = 3 stage), held
     against phase 5's float64 tables;
  8. ``sv_macro_tet`` on K3's sd = 3 stage, at ``pts3``: ``interpolate_rows``
     on a ``BatchedTabulator(zoo, order=0)`` on the default device (K1 and
     K3 on one folded row per program, no K45) and
     ``device_tabulator(..., order=1, f64=False).tables`` (K6's sd = 3
     stage and K3 float32), held against phase 6's float64 tables; K3 in
     f64 on the f64 engine's merged arrays against K7, both timed;
  9. ``c1_macro_zoo`` and ``c1_macro_hessians`` (bench.py:825-837: Hermite,
     Morley, Argyris 5, Bell, HCT 3, PS6 and PS12 at order 1 and 2), and the
     same zoo at order 3 (K3's A 330 x 138, past a block's shared memory),
     through ``device_tabulator(..., order=1|2|3, device="cuda").block_tables``
     (K1, K2 and K3's sd = 2 stage over 21 subcells; K7 timed beside K3);
 10. ``families_tri`` at ``pts2``: the nodal simplicial families of
     fiat_tpu's nodality sweep on the triangle (``FAMILIES_TRI``,
     ``COMPOSITES_TRI``: Crouzeix-Raviart, Taylor, DRT, NED2, BDFM, Regge,
     HHJ, GLS, GL, GLL, bubbles, KMV, restricted and enriched elements; 63
     elements, widths 1-45, tensor-valued rows among them) through every
     entry point on the default device: ``device_tabulator(..., order=1)
     .block_tables`` (K1, K2; K2 also timed on each width group alone),
     ``moment_rows`` (K45) and ``interpolate_rows`` (K1) on a
     ``BatchedTabulator(zoo, order=0)``, and the f32 ``tables`` (K6), held
     against the f64 tables;
 11. ``families_tet`` at ``pts3``, the same on the tetrahedron (47 elements,
     6732 rows, 21.5 GB of f64 tables a pass);
 12. bench.py's ``hdiv_hcurl_tri`` (RT, Nedelec and BDM 1-6 at ``pts2``) and
     ``p2_tri_deg4rule`` (P2 at the degree-4 rule tiled to 1e5 points) on
     the f64 engine (K1, K2);
 13. ``hex_gll_sumfact`` (bench.py:515-579): GaussLobattoLegendre 8 on the
     interval tabulated on the host at the 46-point Gauss-Jacobi rule, the
     three sum-factorised ``torch.einsum`` contractions on the card in
     float64 over a 46^3 field, held to the port's dense hexahedral
     element (``FlattenedDimensions`` of GLL x GLL x GLL, 729 x 97,336,
     tabulated on the host) contracted with the weights and the field by
     one ``torch.matmul`` on the card (no kernel of the port runs here, nor
     a Pallas kernel in fiat_tpu);
 14. ``stokes_elasticity_tri`` at ``pts2``: the Stokes, elasticity and C2
     families of fiat_tpu's nodality sweep on the triangle (``STOKES_TRI``:
     WuXu, Bramble-Zlamal, AlfeldC2 on the double Alfeld split,
     Bernardi-Raugel, Mardal-Tai-Winther, Arnold-Winther, Hu-Zhang,
     Johnson-Mercier, Alfeld-Sorokina, Arnold-Qin, Christiansen-Hu,
     Guzman-Neilan; 21 elements, 42 subcells in 9 macro programs) through
     every entry point: the f64 tables (K1, K2, K7; K3 on the same merged
     programs held to K7 and timed beside it), ``moment_rows`` (K45),
     ``interpolate_rows`` (K1, K3 one row per program) and the f32
     ``tables`` (K6, K3 float32);
 15. ``stokes_elasticity_tet`` at ``pts3``: the same on the tetrahedron
     (``STOKES_TET``, NodalEnriched-GN and Walkington; 12 elements, 44
     subcells in 9 programs);
 16. ``split_variants_tri`` at ``pts2``: the split variants (``SPLIT_TRI``:
     RT, Nedelec, BDM, CR, NED2, Regge, HHJ and GLS of both kinds at degree
     1 on the Alfeld, Powell-Sabin, Powell-Sabin(12) and Iso(2) splits,
     BDFM 2 on three of them, RT 3 and Nedelec 3 on Alfeld and Iso(2), the
     iso variants of Lagrange 1-3 and DG 1, and the ten families unsplit;
     57 elements, 273 subcells in 47 programs, 9.7 GB of f64 tables a
     pass) through every entry point, as phases 14-15 (K1, K2, K7; K3 on
     the same merged programs held to K7 and timed beside it, with its
     plain version and one DGEMM on its masked B; K45; K1 and K3 one row
     per program; K6 and K3 float32);
 17. ``split_variants_tet`` at ``pts3``: the same on the tetrahedron
     (``SPLIT_TET``: the nine families on the Alfeld split, RT, Nedelec,
     CR and NED2 on the Worsey-Farin, Powell-Sabin (24 subcells) and Iso(2)
     splits, Lagrange 1 and DG 1 iso, the nine unsplit; 32 elements, 228
     subcells in 23 programs, 16.8 GB of f64 tables a pass);
 18. ``iso_refined_tri`` at ``pts2``: the iso(k) refinements (``ISO_TRI``:
     Lagrange 1 on iso(6), iso(8) and iso(10), Lagrange 2 and 6, RT,
     Nedelec and CR 1 on iso(6), and the families unsplit), programs of 36
     to 100 subcells, past one 32-bit mask word, through every entry point
     as phases 14-17 (K1, K2, K7; K3 on the same merged programs held to K7
     and timed beside it; K45; K1 and K3 one row per program; K6 and K3
     float32);
 19. ``k3_wide_chunks``: three zoos of one macro element beside P1 whose K3
     tables chunk and Phi tile pass a block's shared memory, so that K3
     streams them through its ring (``K3_WIDE``: Lagrange 9 on PS12 and
     Lagrange 10 on iso(5) at ``pts2``, f64 tables on K1 + K2 + K3;
     Lagrange 7 on Worsey-Farin at ``pts3``, f64 tables on K7), each
     through every entry point (K3 float32 and one row per program in all
     three); their ill-conditioned elements held to host on bars of their
     own (``ILL_CONDITIONED``, ``F32_NO_DIGITS``);
 20. ``interval_zoo`` at 1e5 points of the interval (the generator's first
     draw, uniform in [0, 1)): the interval families (``INTERVAL_ZOO``:
     Lagrange, DG, GLL, GL, GaussRadau, Legendre, IntegratedLegendre and
     Bubble to degree 15, CubicHermite, Histopolation, the FDM family, and
     the split interval elements, Lagrange 1 on iso(64) a program of 64
     subcells among them; 220 elements, 3.1 GB of f64 tables a pass)
     through every entry point (K1, K2 and K3 at sd = 1; K45; K1 and K3 one
     row per program; K6 and K3 float32), held to host relative to max(1,
     max |table|), and ``INTERVAL_BERNSTEIN`` (Lagrange, DG, GLL and
     FDMLagrange 15) on the Bernstein route (K8 + K2);
 21. ``tp_zoo``: the tensor-product cells and the composite elements
     (``tp_zoo``: on the quadrilateral Q 1-8 and DQ 0-6 as flattened
     products of interval elements, RTCF and RTCE 1-4, S 1-6, DPC 0-6,
     SminusF, SminusE, BDMCF and BDMCE 1-3; on the hexahedron Q 1-4, DQ
     0-3, NCF and NCE 1-2, S 1-4, DPC 0-3, SminusE 1-3; HDivTrace 0-3 on
     I x I; MixedElement and QuadratureElement on the triangle; 78
     elements) built and tabulated at order 1 on the host, held finite,
     FlattenedDimensions to its TensorProductElement, MixedElement blocks
     to their members; the product check: every Q and DQ's interval
     factors through ``device_tabulator(factors, order=1)`` at each column
     of the 1e5 points (K1 at sd = 1 and K2, five launches each), their
     Kronecker products by ``torch.einsum`` on the card held to host
     ``TensorProductElement.tabulate``; the Bernstein check: ``Bernstein``
     on the interval and triangle at degrees 1-15 and the tetrahedron at
     1-10 against K8 (``BernsteinFeatures``, rows permuted to the
     element's) on the card;
 22. ``rest_of_core``: the Grundmann-Moller ("gm") rules on the interval,
     triangle and tetrahedron against the exact integrals of monomials,
     summed on the card; the fourteen functional classes of the rest of
     core (point normal, tangential and second derivatives, moments of
     divergence and of normal and tangential traces, the Legendre normal
     and tangential moments) read on ``full_zoo`` (with Regge 2 and
     Hellan-Herrmann-Johnson 1 for the tensor-valued one) tabulated on the
     card at order 2 (K1, K2, K3) and on ``hdiv_hcurl_tet`` (the face
     tangent moment), against host el.tabulate;
 23. ``per_program_macro``: fiat_tpu's per-program macro route by group, at
     1e5 points, on ``full_zoo``'s macro programs with a parent moved to
     another basis as the tests move it (``rebase_program``: another
     scale, then a variant parent), on ``sv_macro_tet``'s with one on
     another cell map, and on DG 0 beside Lagrange 2 on the Alfeld and
     Worsey-Farin splits, which reach it unedited: f64 tables (K1, K2, a K3 a group, K2 on the variant
     parent's masked parent; on the tet a K7 a group, the one off the
     zoo's basis with its own K1), moments (a K45 a group), interpolation
     (K1, a K3 a group) and f32 tables (K6, a K3 float32 a group), one
     launch of each a pass, each route against its plain version, tables
     and moments held to host;
 24. ``jets``: ``device_tabulator(full_zoo, order=1, derivs="jets")``,
     which keys the value table alone, as fiat_tpu's engines do under
     jets: K1, K2 and K3 once each, against their plain versions, host and
     the dmats engine's values;
 25. ``sharded``: ``full_zoo`` at 1e5 points through every step of
     ``fiat_tpu_torch.parallel.sharding`` (tabulation on the f64 kernel
     engine at order 0, its block tables at order 1, 1-D and 2-D moments
     with their all-reduce, the 2-D step in the world of two also on a
     (points 2, rows 1) mesh, so that its all-reduce crosses ranks,
     interpolation) in a world of one process on NCCL and a world of two
     processes on gloo on the one card, each rank's kernels counted, every
     step held to the unsharded engine on the card, each step's time and
     its all-reduce's share printed;
 26. ``symbolic``: the symbolic layer on the card.  ``ElementTabulator``
     (one element on the f64 kernel engine, the default device) on
     Lagrange 4 at ``pts2`` and ``tet_lagrange8`` at ``pts3``, order 1: one
     K1 and one K2 launch each, each kernel against its plain version,
     host parity, the tet tables equal to phase 5's; then the symbolic
     tensor path, ``basis_evaluation(1, UnknownPointSet(P))`` at 1e5
     points on the card, of every stamped wrapper of the FIAT bridge and
     of the product, flattened, enriched, mixed, H(div) and H(curl)
     wrappers, held to host; dual evaluation on a torch function on the
     card; the GLL Q8 hexahedron's identity on the card.  That path runs
     torch operations, no hand-written kernel (fiat_tpu's traced path runs
     XLA outside any Pallas kernel), and counts none;
 27. ``zany``: the physically mapped elements of the symbolic layer on the
     card, their geometry callbacks float64 tensors there
     (``SimplexGeometry`` from a cell's vertices): (1) the 37 cases of
     tests/test_zany_mapping.py (``ZANY_SCALAR``, ``ZANY_PIOLA``) on its
     distorted triangle and tetrahedron, M on the card held to M from
     numpy geometry, ``basis_evaluation(1, UnknownPointSet(P),
     coordinate_mapping=...)`` at ``pts2`` / ``pts3`` held to the host's
     mapped tables, and the physical check (``zany_physical_check``);
     (2) M of ``full_zoo``'s six zany families over 1e5 distorted triangles
     in one ``torch.func.vmap`` each, the reference tables at a degree-10
     rule mapped for every cell in one batched product, 64 sampled cells
     held to numpy geometry and host; (3) ``full_zoo``'s f64 engine (phase
     2's), one ``block_tables`` call (K1, K2, K3 once each), its zany
     blocks mapped by M through ``MappedTabulation`` and held to the
     tensor path; (4) DirectSerendipity 1-4 with tensor vertices at 1e5
     tensor points, held to host.  M and the mapped tables are torch
     operations (fiat_tpu builds and applies M in XLA outside any Pallas
     kernel); part 3's kernels are phase 2's and add no entry;
 28. ``factory``: element descriptions through the factory on the card:
     (1) ``full_zoo``'s 42 elements written as ``fiat_tpu_torch.ufl``
     descriptions (``full_zoo_descriptions``: Lagrange and DG equispaced,
     as the factory's default is spectral), converted by ``create_element``
     and put through ``device_tabulator(..., order=1)`` on the default
     device at ``pts2``: K1, K2 and K3 once each a pass, each against its
     plain version, host parity, the block tables equal bit for bit to
     phase 2's engine, whose kernel times its entries carry (equal tables,
     equal arrays; timed on its own engine when the phase runs alone);
     (2) ``ElementTabulator`` on Lagrange 4 from its description (K1 +
     K2), held to host; (3) examples/assemble_mass.py on the card, on
     that one ``ElementTabulator``: tabulated at the degree-8 rule, M and K by
     ``ir.contract``, sum(M) against the cell's volume, K @ 1 against 0,
     both against a host assembly, ``ir.cost_analysis`` against the
     analytic counts; (4) ``ir`` on the card: ``as_graph`` and
     ``evaluate`` of the symbolic tensor path equal to the direct call,
     ``as_graph`` of the kernel engine refused (``NotTraceable``);
 29. ``high_degree``: the HIGH_DEGREE zoos through every entry point on
     the generic instantiations of K1, K3, K45 and K6
     (``high_degree_phase``);
 30. ``wide_basis``: the WIDE zoos (tet GLL Lagrange 15, 16, 20 and DG 20;
     triangle GLL Lagrange 40 and DG 40) through every entry point, K2 in
     its streamed mode and K6 in its wide mode (its Phi stage and its
     product); the Bernstein elements and routes at fiat_tpu's highest
     degrees on K8's generic instantiation; ``ElementTabulator`` on tet GLL
     Lagrange 20 (``wide_phase``).

On the way it builds the CUDA kernels from ``fiat_tpu_torch/csrc``, holds
each kernel against its plain PyTorch version at the shapes each path
gives it, checks that each path launched every kernel of it (exactly once
from phase 2 on; K45's calls, in the profiler's trace, launch nothing
else, and K45's resident warps an SM are printed), checks the result
against host tabulation, and times the kernel path against the plain path
with CUDA events.

Usage (from the repository root, on a machine with a CUDA card):

    python3 chip_smoke.py
    python3 chip_smoke.py --k3-cells ROOT   # K3 alone per cell, package at ROOT
    python3 chip_smoke.py --k2-cells ROOT   # K2 alone per cell, package at ROOT
    python3 chip_smoke.py --k45-cells ROOT  # K45 alone per cell, package at ROOT
    python3 chip_smoke.py --k6-cells ROOT   # K6 alone per cell, package at ROOT
    python3 chip_smoke.py --k7-cells ROOT   # K7 alone per cell, package at ROOT
    python3 chip_smoke.py --k1-cells ROOT   # K1 and K8 alone per cell, package at ROOT
    python3 chip_smoke.py --phases 23,28    # some of phases 22-30 alone (a quick check)

Prints the card's name and power limit, the build time, K3's, K45's, K6's,
K2's and K7's registers by instantiation and the spills (it fails where K6
or K7 spills), the DMMA instructions in each of K2's instantiations (it fails
where one has none), K6's plan and resident blocks an SM in each f32 cell
(it fails below the plan's), K7's plan and resident blocks in phase 6 (the
same check), one line per step, a JSON line ``{"kernels": [...]}`` (K1, K2 and K3 measured on
``full_zoo``, K45 on the moments phase with K3 on its interpolation, K6
on the f32 phase, K1, K2 (on both routes) and K8 on the tetrahedra, K7
on ``sv_macro_tet`` and on the Worsey-Farin DG 6 zoo, K45 at sd = 3 on
phase 7's three cells and K6 at sd = 3 on two, K3's sd = 3 stage and K6 on
phase 8's, K3 on the C1 zoos (order 1, 2 and 3), K1, K2, K45 and K6 on
phases 10 and 11, K1 and K2 on phase 12, K1, K2, K7, K45, K3 (one
row per program and float32) and K6 on phases 14-18, K1, K2, K3 (or
K7), K45, K3 one row per program and float32 and K6 on phase 19, K1,
K2, K3, K45, K3 one row per program and float32, K6, and K8 + K2 at sd = 1
on phase 20, K1 and K2 on phase 21's factor tables and K8 on its
Bernstein elements (sd 1-3 at their top degrees), the per-program routes'
K3, K2, K7, K45 and K3 float32 of phase 23, K1 and K2 under jets (phase
24), rank 0's K45 and K2 in each world of phase 25, K1 and K2 of
``ElementTabulator``'s two cells in phase 26, and K1, K2 and K3 of the
factory-built ``full_zoo`` and K1 and K2 of its Lagrange 4 in phase 28,
the generic stages of phase 29, and phase 30's K1, K2 streamed, K45, K6
wide and its Phi stage, and K8 generic, each with its bound:
the larger of its bytes over the HBM rate and its operations over the peak
rate for their type), and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero, printing no result, if any phase fails or there is no
CUDA device.
"""

import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

NPTS = 100_000
SEED = 42
HOST_CHECK_PTS = 2000
HOST_ATOL = 1e-10        # the BASELINE.json parity metric
KERNEL_RTOL = 1e-13      # kernel vs plain, relative to max |plain| (float64)
F32_KERNEL_RTOL = 1e-5   # float32 kernel vs plain: only the order of operations differs
F32_RTOL = 5e-6          # f32 plain rows vs float64, per alpha (tests/test_device_ops.py:143)
F32_MACRO_TOL = 5e-5     # f32 macro rows vs float64, / (max abs + 1) (:586-589)
DG6_HOST_RTOL = 1e-9     # Worsey-Farin DG 6 vs host, / max(1, max |table|) per alpha
BIG_NPTS = 10_000_000    # moments streamed from HBM: 240 MB of points and weights
STACK_SLICE = 1_000_000  # points per slice of a K45 stack built for its DGEMV
REPS = 10
INNER = 10
#: in phase 29's cells (``high_degree_phase`` sets ``long_call_ms`` to it),
#: a call at least this long (ms) is timed one call a sample (its K3 and K7
#: take 27-79 ms a call); every other phase times runs of INNER calls
LONG_CALL_MS = 10.0
long_call_ms = None
SPIN_CYCLES = 20_000_000  # ~10 ms of clock cycles queued ahead of timed calls
PROFILE_PAD_S = 0.2       # host seconds around a profiled run
# the H100 SXM's published peaks (NVIDIA's data sheet), per millisecond
HBM_BYTES_MS = 3.35e9    # 3.35 TB/s
FP64_FMA_MS = 33.5e9     # 33.5 TFLOP/s FP64 outside the tensor cores
FP64_MMA_MS = 67e9       # 67 TFLOP/s FP64 matrix products on the tensor cores (DMMA)
FP32_FMA_MS = 67e9       # 67 TFLOP/s FP32 outside the tensor cores (no TF32)
# flops of one recurrence level, (a fa - b fb) prev - (c fc) prev2, times its norm
REC_FLOPS = 8


def fail(msg):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def card_line():
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_entries(log):
    """Per kernel entry function in nvcc's ``-Xptxas -v`` output: [mangled
    name, registers, spill stores, spill loads, stack frame (bytes)]."""
    rows = []
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            rows.append([m.group(1), None, 0, 0, 0])
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill "
                      r"loads", line)
        if rows and m:
            rows[-1][2:] = int(m.group(2)), int(m.group(3)), int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if rows and m:
            rows[-1][1] = int(m.group(1))
    return rows


K2_INSTANCES = 6     # point tiles 128, 64, 32, each for 1 and 2 blocks an SM
K7_INSTANCES = 6     # sd 2 and 3, each at point tiles 64, 128 and 256


def k2_instance(name):
    """'K2 TP <point tile> x<blocks an SM>' for a mangled K2
    instantiation, or None."""
    m = re.search(r"bucket_matmul_kernelILi(\d+)ELi(\d+)EE", name)
    return f"K2 TP {m.group(1)} x{m.group(2)}" if m else None


def print_ptxas(log):
    """The registers of K1's instantiations by (sd, points a thread, row
    filter), degree 0 to 15 (to 10 at sd = 3) and generic, K3's by (sd,
    chunk height, type),
    degree 0 to 10 (to 15 at sd = 1), K45's by sd, degree 0 to 10 (to 15 at
    sd = 1), K6's by (sd, point tile), degree 0 to 15 (to 10 at sd = 3),
    K2's registers and spills by instantiation, K7's registers, spills and
    stack by (sd, point tile), and every kernel that spills; fails where a
    K6 or K7 instantiation spills."""
    if not log:
        print("ptxas: no build log (a matching build existed)")
        return
    k3, k45, k6, k2, k7, spills, no_spill = {}, {}, {}, [], {}, [], []
    k1 = {}
    for name, regs, st, ld, frame in ptxas_entries(log):
        m = re.search(r"dubiner([123])_values_kernel(_n|_bounded)?(?:ILi(n?\d+)E)?", name)
        if m:
            generic = m.group(2) == "_n" or m.group(3) == "n1"
            bounded = m.group(2) == "_bounded"
            kind = (int(m.group(1)), "pair" if bounded or "4Pair" in name else "double",
                    "groups" if bounded or "9GroupRows" in name else "every row")
            k1.setdefault(kind, {})["generic" if generic else int(m.group(3))] = regs
            name = f"K1 sd {kind[0]} {kind[1]} {kind[2]} degree {m.group(3) or 'n'}"
        m = re.search(r"masked_matmul_kernelILi(\d+)ELi(\d+)E", name)
        if m:
            sd, tp = map(int, m.groups())
            k7[(sd, tp)] = (regs, st, ld, frame)
            name = f"K7 sd {sd} TP {tp}"
            if st or ld:
                no_spill.append(name)
        m = re.search(r"zoo_f32_kernelILi(\d+)ELi(\d+)ELi(\d+)E", name)
        if m:
            sd, n, tp = map(int, m.groups())
            k6.setdefault((sd, tp), {})[n] = (regs, frame)
            name = f"K6 sd {sd} degree {n} TP {tp}"
            if st or ld:
                no_spill.append(name)
        m = re.search(r"pair_moments_kernelILi(\d+)ELi(\d+)E", name)
        if m:
            sd, n = int(m.group(1)), int(m.group(2))
            k45.setdefault(sd, {})[n] = (regs, frame)
            name = f"K45 sd {sd} degree {n}"
        m = re.search(r"macro_oneshot_kernelILi(\d+)ELi(\d+)ELi(\d+)E([df])", name)
        if m:
            sd, n, rc, t = int(m.group(1)), int(m.group(2)), int(m.group(3)), m.group(4)
            k3.setdefault((sd, rc, "double" if t == "d" else "float"), {})[n] = regs
            name = f"K3 sd {sd} RC {rc} {'double' if t == 'd' else 'float'} degree {n}"
        if k2_instance(name):
            name = k2_instance(name)
            k2.append(f"{name}: {regs} registers, spills {st}/{ld} bytes")
        if st or ld:
            spills.append(f"{name[:80]}: {st}/{ld} bytes")
    for (sd, t, keep), regs in sorted(k1.items()):
        print(f"ptxas K1 sd {sd} {t} {keep}: registers by degree "
              f"{[regs.get(n) for n in range(11 if sd == 3 else 16)]}, generic "
              f"{regs.get('generic')}")
    for (sd, rc, t), regs in sorted(k3.items()):
        print(f"ptxas K3 sd {sd} RC {rc} {t}: registers by degree "
              f"{[regs.get(n) for n in range(16 if sd == 1 else 11)]}")
    for sd, by_n in sorted(k45.items()):
        print(f"ptxas K45 sd {sd}: (registers, stack frame bytes) by degree "
              f"{[by_n.get(n) for n in range(16 if sd == 1 else 11)]}")
    for (sd, tp), regs in sorted(k6.items()):
        print(f"ptxas K6 sd {sd} TP {tp}: (registers, stack frame bytes) by degree "
              f"{[regs.get(n) for n in range(11 if sd == 3 else 16)]}")
    print(f"ptxas {'; '.join(sorted(k2))}")
    print("ptxas K7 (registers, spill stores, spill loads, stack frame bytes) by (sd, point "
          f"tile): {json.dumps({f'{sd} {tp}': v for (sd, tp), v in sorted(k7.items())})}")
    print(f"ptxas spill stores/loads: {spills if spills else 'none'}")
    if k7 and len(k7) != K7_INSTANCES:     # (an older checkout's K7 has other names)
        fail(f"ptxas reported {len(k7)} K7 instantiations, not {K7_INSTANCES}")
    if no_spill:
        fail(f"K6 and K7 must not spill: {no_spill}")


def check_k2_sass(lib_path):
    """The DMMA instructions in each of K2's instantiations, from
    ``cuobjdump -sass`` of the built library; fails where an instantiation
    has none (K2 must multiply on the FP64 tensor cores)."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not Path(tool).exists():
        print("sass: cuobjdump not found, DMMA not checked")
        return
    out = subprocess.run([tool, "-sass", str(lib_path)], capture_output=True, text=True,
                         timeout=300, check=True).stdout
    counts, name = {}, None
    for line in out.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = k2_instance(m.group(1))
            if name:
                counts[name] = 0
        elif name and re.search(r"\bDMMA\b", line):
            counts[name] += 1
    print(f"sass DMMA instructions: {json.dumps(dict(sorted(counts.items())))}")
    if len(counts) != K2_INSTANCES or not all(counts.values()):
        fail(f"K2 must run DMMA in each of its {K2_INSTANCES} instantiations: {counts}")


def k2_rates(mm, ms, npts=NPTS):
    """K2's rate at ``ms`` a call: TFLOP/s (2 K_g flops per output of group
    g) and TB/s of C written."""
    return (f"{matmul_flops(mm, npts) / ms / 1e9:.2f} TFLOP/s, "
            f"{mm.total_rows * npts * 8 / ms / 1e9:.3f} TB/s of C")


def calls_per_sample(fn, torch, calls):
    """``calls``, or, while ``long_call_ms`` is set (phase 29), 1 where one
    fn() call (timed here by CUDA events) takes that long or more: a sample
    of one such call is long enough for the events, and more calls add
    time, not precision."""
    if long_call_ms is None:
        return calls
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return 1 if start.elapsed_time(end) >= long_call_ms else calls


def median_ms(fn, torch, reps=REPS, inner=INNER, warmup=2):
    """Median over ``reps`` samples of the device time of one fn() call,
    each sample a run of ``inner`` calls (one where a call is long in
    phase 29: ``calls_per_sample``) between two CUDA events."""
    for _ in range(warmup):
        fn()
    inner = calls_per_sample(fn, torch, inner)
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def profile_kernels(run, torch, tries=3):
    """{kernel name: (launches, device microseconds)} of run(), from
    torch.profiler's CUDA activity.  The profiler can drop the card's
    kernel events, some or all of a session's: the host's window is padded
    by PROFILE_PAD_S on each side, and a session that saw no kernel at all
    is run again, up to ``tries`` times."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            time.sleep(PROFILE_PAD_S)
            run()
            torch.cuda.synchronize()
            time.sleep(PROFILE_PAD_S)
        seen = {e.key: (e.count, e.self_device_time_total) for e in prof.key_averages()
                if e.device_type == DeviceType.CUDA and e.count}
        if seen:
            return seen
    return {}


def device_ms(fn, torch, calls=INNER):
    """Mean device time of the kernels one fn() call launches, from
    torch.profiler's CUDA activity over ``calls`` calls (host time not
    included: what the card spends, where a wrapper's host time hides it
    from CUDA events); None if the profiler saw no device time."""
    fn()
    torch.cuda.synchronize()
    seen = profile_kernels(lambda: [fn() for _ in range(calls)], torch)
    total = sum(us for _, us in seen.values())
    return total / calls / 1000 if total else None


def plain_ms(fn, torch):
    """``median_ms`` of a plain PyTorch version at fewer samples (3 of 3
    calls): a reference path whose time is reported, not held, and which
    takes up to 0.17 s a call on the zoos of phases 14-19."""
    return median_ms(fn, torch, reps=3, inner=3, warmup=1)


def kernel_ms(fn, torch, name, calls=INNER):
    """Mean device time of the kernels one fn() call launches whose name
    holds ``name`` (one kernel's share of ``device_ms``), or None."""
    fn()
    torch.cuda.synchronize()
    seen = profile_kernels(lambda: [fn() for _ in range(calls)], torch)
    total = sum(us for key, (_, us) in seen.items() if name in key)
    return total / calls / 1000 if total else None


def queued_ms(fn, torch, calls=INNER, spin_cycles=SPIN_CYCLES):
    """Device time of one fn() call by CUDA events, the ``calls`` calls
    queued behind a spin of ``spin_cycles`` clock cycles, so that the
    events bracket the kernels alone and not the host's time to issue
    them: the median of REPS samples (of one call each where a call is
    long in phase 29: ``calls_per_sample``).  Unlike the profiler
    (``profile_kernels``), these events drop nothing."""
    calls = calls_per_sample(fn, torch, calls)
    times = []
    for _ in range(REPS):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(spin_cycles)
        start.record()
        for _ in range(calls):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return statistics.median(times)


def device_kernels(fn, torch):
    """{kernel name: launches} of one fn() call, from torch.profiler's CUDA
    activity."""
    fn()
    torch.cuda.synchronize()
    return {name: n for name, (n, _) in profile_kernels(fn, torch).items()}


def check_k45_alone(name, pm, P, wf, torch):
    """K45's wrapper launches its kernel and nothing else (the blocks'
    partials are summed inside that launch; its counter holds it to one
    launch a call): no other kernel in the profiler's trace of INNER calls
    (which may drop an event); prints the resident warps an SM."""
    kernels = device_kernels(lambda: [pm(P, wf) for _ in range(INNER)], torch)
    if not kernels or any("pair_moments" not in k or n > INNER for k, n in kernels.items()):
        fail(f"{name}: a K45 call must launch K45 alone, got {kernels} in {INNER} calls")
    print(f"{name} K45: one launch a call, nothing else on the card; {pm.warps} warps a "
          f"block, {pm.blocks_per_sm} blocks = {pm.resident_warps} resident warps an SM "
          f"({pm.smem} bytes of shared memory a block)")


def host_ms(fn, torch, reps=REPS, inner=INNER):
    """Median over ``reps`` samples of the host time of one fn() call: the
    wall clock of ``inner`` calls issued back to back, without waiting for
    the card (what a host-bound pass costs the host alone)."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(inner):
            fn()
        times.append((time.perf_counter() - t0) * 1000 / inner)
        torch.cuda.synchronize()
    return statistics.median(times)


def clock_under_load(fn, torch, seconds=1.5):
    """The SM clock (MHz) and power draw (W) that ``nvidia-smi`` reads,
    every 100 ms, while fn() runs back to back for ``seconds``: medians."""
    smi = subprocess.Popen(["nvidia-smi", "-i", "0", "--query-gpu=clocks.sm,power.draw",
                            "--format=csv,noheader,nounits", "-lms", "100"],
                           stdout=subprocess.PIPE, text=True)
    t0 = time.perf_counter()
    while time.perf_counter() - t0 < seconds:
        for _ in range(INNER):
            fn()
        torch.cuda.synchronize()
    smi.terminate()
    out = smi.communicate(timeout=30)[0]
    rows = [[float(v) for v in line.split(",")] for line in out.splitlines()
            if line.strip() and "[" not in line]
    rows = rows[len(rows) // 3:] or rows            # past the ramp
    return (statistics.median(r[0] for r in rows) if rows else None,
            statistics.median(r[1] for r in rows) if rows else None)


def rel_err(got, want, rows=2048):
    """Max abs difference and max abs of ``want``, over chunks of ``rows``
    rows (no temporary of the whole tables): (err, err / scale)."""
    err = scale = 0.0
    for s in range(0, want.shape[0], rows):
        w = want[s:s + rows]
        scale = max(scale, w.abs().max().item())
        err = max(err, (got[s:s + rows] - w).abs().max().item())
    return err, err / scale if scale else err


def check_kernel(name, got, want, torch, rtol=KERNEL_RTOL):
    """Max abs and relative difference of a kernel from its plain version;
    fails past rtol."""
    torch.cuda.synchronize()
    err, rel = rel_err(got, want)
    print(f"{name} vs plain: max abs {err:.3e}, rel {rel:.3e}")
    if not rel <= rtol:
        fail(f"{name} disagrees with its plain version: rel {rel:.3e} > {rtol}")
    return err


def check_scaled(name, got, want, scales, rtol=KERNEL_RTOL, rows=2048):
    """A kernel against its plain version row by row, each row relative to
    ``scales``' entry for it (``row_scales``: the scale that row's sums
    round at, where a change of basis cancels far below it; a row of scale
    0 must agree exactly); fails past rtol.  Returns the max abs
    difference."""
    err = worst = 0.0
    for s in range(0, want.shape[0], rows):
        d = (got[s:s + rows].double() - want[s:s + rows].double()).abs().amax(dim=1)
        sc = scales[s:s + rows]
        rel = d / sc.clamp_min(1e-300)
        err, worst = max(err, d.max().item()), max(worst, rel.max().item())
    print(f"{name} vs plain: max abs {err:.3e}; worst row {worst:.3e} of its own max |A_r| |B| "
          f"(rows' scales {scales.min().item():.3e} to {scales.max().item():.3e})")
    if not worst <= rtol:
        fail(f"{name} disagrees with its plain version: a row {worst:.3e} of its max |A_r| |B| "
             f"> {rtol}")
    return err


def row_scales(A, B, rows=1024):
    """Per row r of the product A B, max over the points of |A_r| |B| in
    float64: the scale row r's sums round at."""
    import torch
    B = B.double().abs()
    return torch.cat([(A[s:s + rows].double().abs() @ B).amax(dim=1)
                      for s in range(0, A.shape[0], rows)])


def oneshot_scale(mo, P, A=None):
    """``row_scales`` of K3's product: ``A`` its tables' change of basis,
    or one row per program, by its masked parent basis at ``P``."""
    return row_scales(mo.A if A is None else A, mo.operand(P)[0])


def counted(engines, run, torch):
    """Run the main path once with every launch count set to 0 just before
    and read just after: (result, {kernel: launches})."""
    for eng in engines.values():
        eng.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {k: eng.launches for k, eng in engines.items()}


def expect_launches(name, launches, want):
    print(f"{name} launches on the main path: {json.dumps(launches)}")
    if launches != want:
        fail(f"{name}: one pass must launch {want}, got {launches}")


def host_check(zoo, per, pts, npts, torch, np, order=1):
    """Max abs error of the per-element tables against host el.tabulate
    (derivatives up to ``order``) on the first HOST_CHECK_PTS points; fails
    on wrong alphas or shapes."""
    host_err = 0.0
    check = pts[:HOST_CHECK_PTS]
    for el, got in zip(zoo, per):
        want = el.tabulate(order, check)
        if set(want) != set(got):
            fail(f"{type(el).__name__}: alphas {sorted(got)} != {sorted(want)}")
        for a, w in want.items():
            g = got[a]
            if tuple(g.shape) != w.shape[:-1] + (npts,):
                fail(f"{type(el).__name__} {a}: shape {tuple(g.shape)}")
            host_err = max(host_err, float(np.abs(g[..., :HOST_CHECK_PTS].cpu().numpy() - w).max()))
    return host_err


def run_main_path(name, tab, zoo, pts2, torch, np, engines=None, order=1):
    """One pass of ``block_tables`` (derivatives up to ``order``) with the
    launch counts of ``engines`` (by default K1, K2 and K3 where the zoo has
    macro elements) set to 0 just before and read just after; checks
    finiteness and host parity."""
    if engines is None:
        engines = {"K1": tab.recurrence, "K2": tab.matmul}
        if merged_macro(tab) is not None:
            engines["K3"] = merged_macro(tab)
    blocks, launches = counted(engines, lambda: tab.block_tables(pts2), torch)
    finite = all(bool(torch.isfinite(b).all()) for bl in blocks.values() for b in bl)
    host_err = host_check(zoo, tab.unpack(blocks), pts2, NPTS, torch, np, order)
    print(f"{name} main path: block_tables(order {order}) at {NPTS} points: "
          f"{len(zoo)} elements, finite {finite}, max abs err vs host el.tabulate on "
          f"{HOST_CHECK_PTS} points {host_err:.3e}")
    if not finite:
        fail(f"{name}: non-finite values in the tables")
    if not host_err <= HOST_ATOL:
        fail(f"{name}: main path disagrees with host tabulation: {host_err:.3e} > {HOST_ATOL}")
    print(f"{name} launches on the main path: {json.dumps(launches)}")
    if min(launches.values()) < 1:
        fail(f"{name}: a kernel of the main path was not launched: {launches}")
    return launches, host_err


def slice_phase(T, dev, pts2, P, card, torch, np):
    """Phase 1, kept from the first slice: Lagrange 1-10 + DG 1-8 on K1, K2."""
    from fiat_tpu_torch import DiscontinuousLagrange, Lagrange, device_tabulator

    t0 = time.perf_counter()
    zoo = ([Lagrange(T, p) for p in range(1, 11)]
           + [DiscontinuousLagrange(T, p) for p in range(1, 9)])
    tab = device_tabulator(zoo, order=1, device=dev)
    print(f"slice host construction: {len(zoo)} elements, {tab.rows} rows x {len(tab.alphas)} "
          f"alphas, widths {tab.widths}, {time.perf_counter() - t0:.2f} s")
    rec, mm = tab.recurrence, tab.matmul
    phi_p = rec.plain(P)
    check_kernel(f"slice K1 recurrence at {NPTS} points", rec(P), phi_p, torch)
    C_k, C_p = mm(phi_p), mm.plain(phi_p)
    check_kernel(f"slice K2 bucket matmul ({mm.total_rows} x {NPTS})", C_k, C_p, torch)
    worst = max(rel_err(a, b)[1] for a, b in zip(mm.views(C_k), mm.views(C_p)))
    if not worst <= KERNEL_RTOL:
        fail(f"slice K2 disagrees with its plain version on a group: rel {worst:.3e}")
    del phi_p, C_k, C_p
    run_main_path("slice", tab, zoo, pts2, torch, np)
    path_ms = median_ms(lambda: tab.block_tables(P), torch)
    plain_ms = median_ms(lambda: mm.plain(rec.plain(P)), torch)
    print(f"slice timing ({card}; median of {REPS} runs of {INNER}, CUDA events): "
          f"kernel path {path_ms:.4f} ms, plain path {plain_ms:.4f} ms")


def full_zoo(T):
    """The 42 elements of full_zoo, as bench.py:840-862 lists them."""
    import fiat_tpu_torch as ft
    return ([ft.Lagrange(T, p) for p in range(1, 11)]
            + [ft.DiscontinuousLagrange(T, p) for p in range(1, 9)]
            + [ft.RaviartThomas(T, k) for k in range(1, 7)]
            + [ft.Nedelec(T, k) for k in range(1, 7)]
            + [ft.BrezziDouglasMarini(T, k) for k in range(1, 7)]
            + full_zoo_zany(T))


def full_zoo_zany(T):
    """full_zoo's last six elements, its zany ones (bench.py:846-848)."""
    import fiat_tpu_torch as ft
    return [ft.CubicHermite(T), ft.Morley(T), ft.Argyris(T, 5), ft.Bell(T),
            ft.HsiehCloughTocher(T, 3), ft.QuadraticPowellSabin6(T)]


def full_zoo_descriptions(ufl):
    """full_zoo's 42 elements as element descriptions of the package
    ``ufl`` (the port's, or fiat_tpu's in the tests) on the triangle, in
    full_zoo's order.  The factory's default for Lagrange and
    discontinuous Lagrange is spectral (GaussLobattoLegendre,
    GaussLegendre), so those name full_zoo's equispaced variant; the
    registry fixes the zany degrees (Hermite 3, Morley 2, Argyris 5, Bell
    5, HCT 3, PS6 2)."""
    FE = ufl.FiniteElement
    return ([FE("Lagrange", "triangle", p, variant="equispaced") for p in range(1, 11)]
            + [FE("Discontinuous Lagrange", "triangle", p, variant="equispaced")
               for p in range(1, 9)]
            + [FE(family, "triangle", k) for family in ("RT", "N1curl", "BDM")
               for k in range(1, 7)]
            + [FE(family, "triangle", k) for family, k in (
                ("HER", 3), ("MOR", 2), ("ARG", 5), ("BELL", 5), ("HCT", 3), ("PS6", 2))])


def full_zoo_phase(T, dev, pts2, P, card, torch, np):
    """Phase 2: the whole full_zoo on K1, K2 and K3, one launch each."""
    from fiat_tpu_torch import device_tabulator

    t0 = time.perf_counter()
    zoo = full_zoo(T)
    tab = device_tabulator(zoo, order=1, device=dev)
    mo = merged_macro(tab)
    print(f"full_zoo host construction: {len(zoo)} elements, {tab.rows} rows x "
          f"{len(tab.alphas)} alphas, widths {tab.widths}, K3 {mo.rows} x {mo.K} over "
          f"{len(mo.nexp)} subcells (parent degree {mo.degree}), "
          f"{time.perf_counter() - t0:.2f} s")
    if len(zoo) != 42 or merged_macro(tab) is None:
        fail("full_zoo must hold 42 elements, the macro ones on K3")
    errs, launches, host_err = full_zoo_checks("full_zoo", tab, zoo, pts2, P, torch, np)
    ms = full_zoo_times(tab, P, torch)
    phi = tab.recurrence(P)
    k7_ms = k7_on_k3_arrays("full_zoo", mo, phi, P, dev, torch)
    del phi
    rec, mm = tab.recurrence, tab.matmul
    path_ms = median_ms(lambda: tab.block_tables(P), torch)
    plain_ms = median_ms(lambda: (mm.plain(rec.plain(P)), mo.plain(P)), torch)
    gbytes = (mm.total_rows + mo.rows) * NPTS * 8 / 1e9
    print(f"full_zoo timing ({card}; median of {REPS} runs of {INNER}, CUDA events): "
          f"kernel path {path_ms:.4f} ms, plain path {plain_ms:.4f} ms; "
          f"K1 {ms['K1']:.4f} ms (plain {ms['K1 plain']:.4f}), K2 {ms['K2']:.4f} ms = "
          f"{k2_rates(mm, ms['K2'])} (plain {ms['K2 plain']:.4f}, one padded DGEMM "
          f"{ms['K2 library']:.4f}), K3 {ms['K3']:.4f} ms (plain {ms['K3 plain']:.4f}, one DGEMM "
          f"on the masked B {ms['K3 library']:.4f}, K7 on K1's Phi {k7_ms:.4f}); "
          f"a pass writes {gbytes:.3f} GB "
          f"= {gbytes / path_ms:.3f} TB/s; host error {host_err:.3e}")
    return tab, full_zoo_entries(tab, errs, launches, ms), ms


def full_zoo_checks(label, tab, zoo, pts2, P, torch, np):
    """``full_zoo``'s kernels on ``tab``, its f64 engine: K1, K2 and K3
    each against its plain version at P, then one pass of the main path
    (K1, K2 and K3 once each, host parity).  Returns ({kernel: max abs
    error}, {kernel: launches}, the host error)."""
    rec, mm, mo = tab.recurrence, tab.matmul, merged_macro(tab)
    phi_p = rec.plain(P)
    errs = {"K1": check_kernel(f"{label} K1 recurrence at {NPTS} points", rec(P), phi_p, torch),
            "K2": check_kernel(f"{label} K2 bucket matmul ({mm.total_rows} x {NPTS})",
                               mm(phi_p), mm.plain(phi_p), torch),
            "K3": check_kernel(f"{label} K3 macro one-shot ({mo.rows} x {NPTS})",
                               mo(P), mo.plain(P), torch)}
    del phi_p
    launches, host_err = run_main_path(label, tab, zoo, pts2, torch, np)
    if launches != {"K1": 1, "K2": 1, "K3": 1}:
        fail(f"{label}: one pass must launch K1, K2 and K3 once each: {launches}")
    return errs, launches, host_err


def full_zoo_times(tab, P, torch):
    """Each of ``full_zoo``'s kernels on ``tab``, its plain version and its
    library call (K2: one padded DGEMM; K3: one DGEMM on the masked B),
    timed at P: the times by name."""
    rec, mm, mo = tab.recurrence, tab.matmul, merged_macro(tab)
    phi = rec(P)
    A = mm.A.to(phi.device)
    return {"K1": median_ms(lambda: rec(P), torch),
            "K1 plain": median_ms(lambda: rec.plain(P), torch),
            "K2": median_ms(lambda: mm(phi), torch),
            "K2 plain": median_ms(lambda: mm.plain(phi), torch),
            "K2 library": median_ms(lambda: torch.matmul(A, phi[:mm.max_k]), torch),
            "K3": median_ms(lambda: mo(P), torch),
            "K3 plain": median_ms(lambda: mo.plain(P), torch),
            "K3 library": masked_gemm_ms(mo, P, torch)}


def full_zoo_entries(tab, errs, launches, ms, suffix=""):
    """The kernels-line entries of ``full_zoo``'s K1, K2 and K3 on
    ``tab`` (``full_zoo_checks``' errors and launches,
    ``full_zoo_times``' times)."""
    rec, mm, mo = tab.recurrence, tab.matmul, merged_macro(tab)
    return [
        entry("K1 dubiner2_values" + suffix, "fiat_tpu_torch/csrc/recurrence.cu",
              "fiat_tpu/ops/pallas_recurrence.py:399", launches["K1"], errs["K1"], ms["K1"],
              ms["K1 plain"], rec_bound(rec, NPTS)),
        entry("K2 bucket_matmul" + suffix, "fiat_tpu_torch/csrc/bucket_matmul.cu",
              "fiat_tpu/ops/pallas_multiword.py:269", launches["K2"], errs["K2"], ms["K2"],
              ms["K2 plain"], matmul_bound(mm, NPTS), ms["K2 library"]),
        entry("K3 macro_oneshot" + suffix, "fiat_tpu_torch/csrc/macro_oneshot.cu",
              "fiat_tpu/ops/pallas_multiword.py:652", launches["K3"], errs["K3"], ms["K3"],
              ms["K3 plain"], macro_bound(mo, NPTS), ms["K3 library"]),
    ]


def entry(name, source, replaces, launches, err, ms, plain, bound, library=None):
    """One kernel of the ``{"kernels": [...]}`` line; ``bound`` is
    ``bound_of(...)``'s (ms, "bytes" or "operations"), ``library`` the
    time of one PyTorch call computing the same function, or None."""
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain,
            "bound_ms": bound[0], "bound_by": bound[1], "library_ms": library}


def generic(wrapper):
    """" generic" where a kernel wrapper runs its generic instantiation (a
    degree past its unrolled ones), for its kernels-line name."""
    return " generic" if getattr(wrapper, "generic", False) else ""


def merged_macro(engine):
    """The kernel of an engine's first merged macro route (the group on the
    zoo's basis where there is one), read off its route list: the f64
    engine's K3 or K7 (``macro_routes``' ``.engine``), the f32 engine's K3
    float32 (``macro_routes``), the moments engine's K3 for interpolation
    (``macros``); None without merged macro programs."""
    if hasattr(engine, "macros"):
        kernels = engine.macros
    else:
        kernels = [getattr(r, "engine", r) for r in engine.macro_routes
                   if getattr(r, "kind", "merged") == "merged" and r.name != "torch"]
    return kernels[0] if kernels else None


def wide(wrapper):
    """" streamed" (K2) or " wide" (K6) where a kernel wrapper runs the mode
    past its resident Phi tile (phase 30), for its kernels-line name."""
    mode = getattr(wrapper, "mode", None)
    return f" {mode}" if mode in ("streamed", "wide") else ""


def bound_of(nbytes, flops, flops_ms):
    """The least time the card could take: the larger of ``nbytes`` (each
    input read once, each output written once) over the HBM rate and
    ``flops`` over ``flops_ms``, the peak rate for their type."""
    t_bytes, t_ops = nbytes / HBM_BYTES_MS, flops / flops_ms
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def rec_flops(sd, degree):
    """Flops of the Dubiner recurrence at one point: REC_FLOPS for every
    level that steps, one multiply (its norm) for every level 0.  Stage k
    has comb(degree + k + 1, k + 1) levels, one level 0 per input row: one
    in stage 0, then one per entry of the stage before."""
    if degree == 0:
        return 0
    flops, level0 = 0, 1
    for k in range(sd):
        levels = math.comb(degree + k + 1, k + 1)
        flops += REC_FLOPS * (levels - level0) + level0
        level0 = levels
    return flops


def rec_bound(rec, npts):
    """K1: the points in, Phi out; the recurrence at every point."""
    return bound_of(8 * npts * (rec.sd + rec.nexp), rec_flops(rec.sd, rec.degree) * npts,
                    FP64_FMA_MS)


def matmul_flops(mm, npts):
    """2 K_g flops per output of group g."""
    return 2 * sum(r * k for r, k in zip(mm.rows, mm.K)) * npts


def matmul_bound(mm, npts):
    """K2: A (each group at its own width) and Phi[:kmax] in, C out; a
    matrix product, so the FP64 tensor-core rate."""
    nbytes = 8 * (sum(r * k for r, k in zip(mm.rows, mm.K)) + (mm.max_k + mm.total_rows) * npts)
    return bound_of(nbytes, matmul_flops(mm, npts), FP64_MMA_MS)


def one_piece_nexp(geom, piece_nexp):
    """Per macro program, (program, the width of the one subcell an
    interior point bins into)."""
    out, piece = [], 0
    for g in geom:
        out.append((g, piece_nexp[piece]))
        piece += len(g["maps"])
    return out


def macro_bound(mo, npts, itemsize=8, flops_ms=FP64_FMA_MS, one_row=False):
    """K3: the points and A in, the tables out; per point the parent
    recurrence and, for every program, its rows (one with ``one_row``, the
    interpolation's) against the one subcell an interior point bins into."""
    rows = [1 if one_row else g["rows"][1] - g["rows"][0] for g in mo.geom]
    flops = rec_flops(mo.sd, mo.degree) + sum(
        2 * r * nexp for r, (_, nexp) in zip(rows, one_piece_nexp(mo.geom, mo.nexp)))
    return bound_of(itemsize * (npts * mo.sd + sum(rows) * (mo.K + npts)), flops * npts,
                    flops_ms)


def moments_bound(pm, npts):
    """K45: points and weights in, the sums out; per point the recurrence,
    one FMA per plain sum and, for every program, one per member of the one
    subcell an interior point bins into (csrc/moments.cu adds a point only
    into the pieces it lies on)."""
    flops = rec_flops(pm.sd, pm.degree) + 2 * pm.nplain + sum(
        2 * nexp for _, nexp in one_piece_nexp(pm.geom, pm.piece_nexp))
    return bound_of(8 * ((pm.sd + 1) * npts + pm.rows), flops * npts, FP64_FMA_MS)


def zoo_f32_flops(k6, npts):
    """K6's flops: per point the recurrence and 2 K_g flops per row of
    group g."""
    return (2 * sum(r * k for r, k in zip(k6.group_rows, k6.K))
            + rec_flops(k6.sd, k6.degree)) * npts


def zoo_f32_bound(k6, npts):
    """K6: the points and A in, the rows out; its flops at the FP32 rate."""
    nbytes = 4 * (k6.sd * npts + k6.A.numel() + k6.total_rows * npts)
    return bound_of(nbytes, zoo_f32_flops(k6, npts), FP32_FMA_MS)


def zoo_f32_library_ms(k6, P32, torch):
    """One cuBLAS SGEMM (TF32 off) of the zero-padded packed rows by a Phi
    computed beforehand: the library yardstick of K6."""
    from fiat_tpu_torch.ops.kernels import no_tf32
    phi32 = k6.phi(P32)
    with no_tf32():
        A = k6.A.to(phi32.device)
        return median_ms(lambda: torch.matmul(A, phi32[:k6.max_k]), torch)


def k6_plan_line(name, k6):
    """K6's plan and, from the CUDA runtime, the blocks an SM that its
    registers and shared memory allow; fails below the plan's blocks."""
    tp, kc, stages, blocks = k6.plan
    resident = k6.occupancy()
    print(f"{name} K6 plan: {tp}-point tiles, A chunks of {kc} rows in a ring of {stages}, "
          f"{blocks} blocks an SM planned, {resident} resident ({k6.smem} bytes of shared "
          f"memory a block, Phi {k6.kpad} x {tp})")
    if resident < blocks:
        fail(f"{name}: K6 holds {resident} blocks an SM, its plan {k6.plan} needs {blocks}")


def features_bound(feat, npts):
    """K8: the points in, the features out; per point the barycentric map,
    the power table and one multiply per nonzero exponent of each
    feature."""
    sd, n = feat.sd, feat.degree
    per_point = 2 * sd * (sd + 1) + (sd + 1) * max(n - 1, 0) + sum(
        sum(1 for e in mi if e) for mi in feat.mis)
    return bound_of(8 * npts * (sd + feat.nexp), per_point * npts, FP64_FMA_MS)


def make_points(n, seed, np, sd=2):
    """bench.py's pts2 (sd = 2) or pts3 (sd = 3): uniform in the UFC
    simplex's bounding box, pulled into the simplex; pts3 comes from the
    same generator after pts2 (bench.py:764-768).  On the interval (sd = 1)
    the generator's first draw, uniform in [0, 1)."""
    rng = np.random.default_rng(seed)
    if sd == 1:
        return rng.random((n, 1))
    for d in range(2, sd + 1):
        pts = rng.random((n, d))
        pts = pts / (pts.sum(axis=1)[:, None] + 1e-9) * rng.random((n, 1))
    return pts


def host_dual_check(name, zoo, bt, mo, P, pts, wf, wf_h, u, c_h, np):
    """Moments on the first HOST_CHECK_PTS points against host
    el.tabulate(0) @ wf, in the bench's form (bench.py:476-486), and, where
    ``u`` (the main path's interpolated values) is given, its first
    HOST_CHECK_PTS values against host sum_i c_i phi_i; fails past
    HOST_ATOL, or for the SUMMED_MOMENTS elements' moments past their table
    bar (``table_bar``) times the sum of the weights (and the interval's
    INTERVAL_SUMMED elements alike).  Prints the element of the worst
    reading held to HOST_ATOL.  The NO_DIGITS elements' moments are printed,
    not held; where the zoo holds one, the values held to host are those
    of a second interpolation on the first HOST_CHECK_PTS points with
    their rows of c zeroed, so that the rest of the zoo is held (the
    kernels of their path are held to their plain versions)."""
    n = HOST_CHECK_PTS
    sub, wsub = pts[:n], wf_h[:n]
    origin = (0,) * pts.shape[1]
    per = mo.unpack_moments(bt, mo.moment_rows(bt, P[:n], wf[:n]))
    mom_err, worst, host_u, summed, u_bar = 0.0, "", np.zeros(n), [], HOST_ATOL
    no_digits = []
    held = np.array(c_h, copy=True)
    for el, (lo, hi, _) in zip(zoo, bt.slices):
        if split_label(el) in NO_DIGITS:
            held[lo:hi] = 0.0
    if u is not None and not np.array_equal(held, c_h):
        c_h, u = held, mo.interpolate_rows(bt, P[:n], P.new_tensor(held))
    for el, m, (lo, hi, _) in zip(zoo, per, bt.slices):
        tab = np.asarray(el.tabulate(0, sub)[origin]).reshape(hi - lo, n)
        err = float(np.abs(tab @ wsub - m.reshape(-1).cpu().numpy()).max())
        if split_label(el) in NO_DIGITS:
            no_digits.append(f"{split_label(el)} {err:.3e}")
            continue
        interval_summed = on_interval(el) and split_label(el) in INTERVAL_SUMMED
        if split_label(el) in ILL_CONDITIONED or interval_summed:
            u_bar += table_bar(el, tab) * float(np.abs(c_h[lo:hi]).sum())
        if (type(el).__name__ in SUMMED_MOMENTS or split_label(el) in SUMMED_MOMENTS
                or split_label(el) in ILL_CONDITIONED or interval_summed):
            bar = table_bar(el, tab) * float(wsub.sum())
            summed.append(f"{split_label(el)} {err:.3e} (bar {bar:.3e})")
            if not err <= bar:
                fail(f"{name}: moments of {split_label(el)} {err:.3e} from host > {bar:.3e}")
        elif err > mom_err:
            mom_err, worst = err, split_label(el)
        host_u += c_h[lo:hi] @ tab
    interp_err = 0.0 if u is None else float(np.abs(u[:n].cpu().numpy() - host_u).max())
    print(f"{name} vs host el.tabulate(0) on {n} points: moments max abs {mom_err:.3e} "
          f"({worst})"
          + ("" if u is None else f", interpolation max abs {interp_err:.3e} (limit "
             f"{u_bar:.3e})")
          + (f"; moments held to their table bar times the sum of the weights: "
             f"{', '.join(summed)}" if summed else "")
          + (f"; not held (NO_DIGITS): moments of {', '.join(no_digits)} from host (their "
             f"rows of c zeroed in the interpolation held)" if no_digits else ""))
    if not (mom_err <= HOST_ATOL and interp_err <= u_bar):
        fail(f"{name}: moments {mom_err:.3e} > {HOST_ATOL} or interpolation {interp_err:.3e} > "
             f"{u_bar:.3e}")


def moments_phase(T, dev, pts2, P, card, torch, np):
    """Phase 3: moments_interp_full_zoo, moments on K45, interpolation on K1
    and K3, one launch each per pass."""
    from fiat_tpu_torch import device_tabulator
    from fiat_tpu_torch.ops import moments as mo
    from fiat_tpu_torch.ops.tabulate import BatchedTabulator

    t0 = time.perf_counter()
    zoo = full_zoo(T)
    bt = BatchedTabulator(zoo, order=0)     # the default device: the card
    eng = mo.moment_engine(bt)
    pm, rec, m3 = eng.moments, eng.recurrence, merged_macro(eng)
    rows = eng.rows
    print(f"moments host construction: {len(zoo)} elements, {rows} rows, K45 {pm.rows} sums "
          f"(degree {pm.degree}: {pm.nplain} plain + {pm.rows - pm.nplain} masked over "
          f"{len(pm.piece_nexp)} subcells), {time.perf_counter() - t0:.2f} s")
    wf_h = np.random.default_rng(7).random(NPTS)      # bench.py:441
    wf = torch.as_tensor(wf_h, device=dev)
    c_h = np.random.default_rng(11).random(rows) - 0.5
    c = torch.as_tensor(c_h, device=dev)

    k45_abs = check_kernel(f"K45 pair moments ({pm.rows} sums over {NPTS} points)",
                           pm(P, wf), pm.plain(P, wf), torch)
    check_k45_alone("full_zoo", pm, P, wf, torch)
    W = eng.program_columns[0] * (c @ eng.matrix)[eng.nexp:]
    w_abs = check_kernel(f"K3 one row per program ({W.shape[0]} x {W.shape[1]}, interpolation)",
                         m3(P, A=W), m3.plain(P, A=W), torch)

    engines = {"K45": pm, "K1": rec, "K3": m3}
    M, launches = counted(engines, lambda: mo.moment_rows(bt, P, wf), torch)
    expect_launches("moments", launches, {"K45": 1, "K1": 0, "K3": 0})
    moments_launches = launches["K45"]
    u, launches = counted(engines, lambda: mo.interpolate_rows(bt, P, c), torch)
    expect_launches("interpolation", launches, {"K45": 0, "K1": 1, "K3": 1})
    w_launches = launches["K3"]
    if tuple(M.shape) != (rows,) or tuple(u.shape) != (NPTS,):
        fail(f"moments {tuple(M.shape)} / interpolation {tuple(u.shape)}: wrong shapes")
    if not (bool(torch.isfinite(M).all()) and bool(torch.isfinite(u).all())):
        fail("non-finite moments or interpolated values")

    host_dual_check("full_zoo", zoo, bt, mo, P, pts2, wf, wf_h, u, c_h, np)

    def moments_plain(Q, w):
        return eng.matrix @ pm.plain(Q, w)

    def interp_plain(Q):
        folded = c @ eng.matrix
        return (folded[:eng.nexp] @ rec.plain(Q)
                + m3.plain(Q, A=eng.program_columns[0] * folded[eng.nexp:]).sum(dim=0))

    k45_ms, k45_plain = median_ms(lambda: pm(P, wf), torch), median_ms(lambda: pm.plain(P, wf),
                                                                      torch)
    k45_lib = stack_mv_ms(pm, P, wf, torch)
    mom_ms = median_ms(lambda: mo.moment_rows(bt, P, wf), torch)
    mom_plain = median_ms(lambda: moments_plain(P, wf), torch)
    int_ms = median_ms(lambda: mo.interpolate_rows(bt, P, c), torch)
    int_plain = median_ms(lambda: interp_plain(P), torch)
    w_ms, w_plain = median_ms(lambda: m3(P, A=W), torch), median_ms(lambda: m3.plain(P, A=W),
                                                                  torch)
    B = m3.operand(P)[0]
    w_lib = median_ms(lambda: torch.matmul(W, B), torch)      # one DGEMM, B given
    del B
    w_bound = macro_bound(m3, NPTS, one_row=True)
    fz = device_tabulator(zoo, order=0, device=dev)
    via_ms = median_ms(lambda: [b @ wf for b in fz.block_tables(P)[(0, 0)]], torch)
    print(f"moments timing at {NPTS} points ({card}; median of {REPS} runs of {INNER}, CUDA "
          f"events): moment_rows {mom_ms:.4f} ms (plain {mom_plain:.4f}), K45 {k45_ms:.4f} ms "
          f"(plain {k45_plain:.4f}, one DGEMV on its stack built beforehand {k45_lib:.4f}); "
          f"interpolate_rows {int_ms:.4f} ms (plain {int_plain:.4f}); K3 one row per program "
          f"{w_ms:.4f} ms (plain {w_plain:.4f}, one DGEMM on the masked B {w_lib:.4f}, bound "
          f"{w_bound[0]:.4f} by {w_bound[1]})")
    print(f"moments via tables at {NPTS} points ({card}): order-0 f64 engine (K1 + K2 + K3) "
          f"block_tables then each block @ wf: {via_ms:.4f} ms = {via_ms / mom_ms:.1f} x "
          f"moment_rows")
    del fz

    # 1e7 points: points and weights (240 MB) stream from HBM, past the L2
    big = torch.as_tensor(make_points(BIG_NPTS, SEED + 1, np), device=dev)
    wbig = torch.as_tensor(np.random.default_rng(8).random(BIG_NPTS), device=dev)
    check_kernel(f"K45 pair moments ({pm.rows} sums over {BIG_NPTS} points)",
                 pm(big, wbig), pm.plain(big, wbig), torch)
    big_ms = median_ms(lambda: mo.moment_rows(bt, big, wbig), torch)
    big_k45 = median_ms(lambda: pm(big, wbig), torch)
    big_plain = median_ms(lambda: moments_plain(big, wbig), torch, reps=3, inner=2)
    big_k45_plain = median_ms(lambda: pm.plain(big, wbig), torch, reps=3, inner=2)
    big_bound = moments_bound(pm, BIG_NPTS)
    big_lib = stack_mv_ms(pm, big, wbig, torch, reps=5, inner=4)
    print(f"moments timing at {BIG_NPTS} points ({card}; CUDA events): moment_rows "
          f"{big_ms:.4f} ms (plain {big_plain:.4f}), K45 {big_k45:.4f} ms (plain "
          f"{big_k45_plain:.4f}, one DGEMV on its {pm.rows * BIG_NPTS * 8 / 1e9:.1f} GB stack "
          f"built beforehand {big_lib:.4f}, bound {big_bound[0]:.4f} by {big_bound[1]}); "
          f"{24 * BIG_NPTS / 1e9 / big_k45:.3f} TB/s of points and "
          f"weights; plain peak memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    del big, wbig
    torch.cuda.empty_cache()
    return [entry("K45 pair_moments", "fiat_tpu_torch/csrc/moments.cu",
                  "fiat_tpu/ops/pallas_recurrence.py:549, fiat_tpu/ops/pallas_recurrence.py:727",
                  moments_launches, k45_abs, k45_ms, k45_plain, moments_bound(pm, NPTS),
                  k45_lib),
            entry("K3 macro_oneshot (full_zoo interpolation, one row per program)",
                  "fiat_tpu_torch/csrc/macro_oneshot.cu", "fiat_tpu/ops/pallas_multiword.py:652",
                  w_launches, w_abs, w_ms, w_plain, w_bound, w_lib)]


def plain_in_slices(pm, P, wf):
    """K45's plain version over slices of STACK_SLICE points, summed in
    slice order: the same moments with the plain recurrence's temporaries
    kept small."""
    return sum(pm.plain(P[s:s + STACK_SLICE], wf[s:s + STACK_SLICE])
               for s in range(0, P.shape[0], STACK_SLICE))


def stack_mv_ms(pm, P, wf, torch, **timing):
    """One cuBLAS DGEMV of K45's (rows, npts) stack, built beforehand (in
    slices of STACK_SLICE points, so that the plain recurrence's
    temporaries stay small beside it), by the weights: the library
    yardstick of K45."""
    B = torch.empty((pm.rows, P.shape[0]), dtype=torch.float64, device=P.device)
    for s in range(0, P.shape[0], STACK_SLICE):
        B[:, s:s + STACK_SLICE] = pm.stack(P[s:s + STACK_SLICE])
    ms = median_ms(lambda: torch.mv(B, wf), torch, **timing)
    del B
    torch.cuda.empty_cache()
    return ms


def f32_phase(T, dev, P, ref64, card, torch):
    """Phase 4: full_zoo on the f32 engine, K6 and K3 in float32, one
    launch each; held against phase 2's float64 tables ``ref64``."""
    from fiat_tpu_torch import device_tabulator

    t0 = time.perf_counter()
    zoo = full_zoo(T)
    tab = device_tabulator(zoo, order=1, f64=False, device=dev)
    k6, m3 = tab.kernel, merged_macro(tab)
    if k6.variant is not None:
        fail("f32: full_zoo's target basis is the plain Dubiner one")
    print(f"f32 host construction: {len(zoo)} elements, {tab.rows} rows x {len(tab.alphas)} "
          f"alphas, K6 {k6.total_rows} rows in widths {k6.K}, K3 float32 {m3.rows} x {m3.K}, "
          f"{time.perf_counter() - t0:.2f} s")
    k6_plan_line("f32 full_zoo", k6)
    P32 = P.float()
    shape = (k6.total_rows, NPTS)
    k6_abs = check_kernel(f"K6 f32 zoo ({k6.total_rows} x {NPTS})",
                          k6(P32, tab.dst_plain, torch.empty(shape, device=dev)),
                          k6.plain(P32, tab.dst_plain, torch.empty(shape, device=dev)),
                          torch, F32_KERNEL_RTOL)
    m3_abs = check_kernel(f"K3 float32 macro one-shot ({m3.rows} x {NPTS})", m3(P32),
                          m3.plain(P32), torch, F32_KERNEL_RTOL)

    tables, launches = counted({"K6": k6, "K3 float32": m3}, lambda: tab.tables(P), torch)
    expect_launches("f32", launches, {"K6": 1, "K3 float32": 1})
    f32_vs_f64("f32", tab, zoo, tables, ref64, torch)
    del tables

    out = torch.empty(shape, device=dev)
    k6_ms = median_ms(lambda: k6(P32, tab.dst_plain, out), torch)
    k6_plain = median_ms(lambda: k6.plain(P32, tab.dst_plain, out), torch)
    m3_ms, m3_plain = median_ms(lambda: m3(P32), torch), median_ms(lambda: m3.plain(P32), torch)
    m3_lib = masked_gemm_ms(m3, P32, torch)
    k6_lib = zoo_f32_library_ms(k6, P32, torch)
    del out
    path_ms = median_ms(lambda: tab.tables(P), torch)
    full = torch.empty((len(tab.alphas) * tab.rows, NPTS), device=dev)
    plain_ms = median_ms(lambda: (k6.plain(P.float(), tab.dst_tables, full),
                                  full.index_copy_(0, tab.dst_macro, m3.plain(P.float()))), torch)
    del full
    gbytes = len(tab.alphas) * tab.rows * NPTS * 4 / 1e9
    print(f"f32 timing ({card}; median of {REPS} runs of {INNER}, CUDA events): tables "
          f"{path_ms:.4f} ms, plain path {plain_ms:.4f} ms; K6 {k6_ms:.4f} ms (plain "
          f"{k6_plain:.4f}), K3 float32 {m3_ms:.4f} ms (plain {m3_plain:.4f}, one SGEMM on the "
          f"masked B {m3_lib:.4f}); a pass writes "
          f"{gbytes:.3f} GB = {gbytes / path_ms:.3f} TB/s (K6 alone "
          f"{k6.total_rows * NPTS * 4 / 1e9 / k6_ms:.3f} TB/s; one padded SGEMM on a computed "
          f"Phi {k6_lib:.4f} ms)")
    return [entry("K6 zoo_f32", "fiat_tpu_torch/csrc/zoo_f32.cu",
                  "fiat_tpu/ops/pallas_tabulate.py:248", launches["K6"], k6_abs, k6_ms,
                  k6_plain, zoo_f32_bound(k6, NPTS), k6_lib),
            entry("K3 macro_oneshot float32", "fiat_tpu_torch/csrc/macro_oneshot.cu",
                  "fiat_tpu/ops/pallas_multiword.py:652", launches["K3 float32"], m3_abs, m3_ms,
                  m3_plain, macro_bound(m3, NPTS, 4, FP32_FMA_MS), m3_lib)]


def f32_vs_f64(name, tab, zoo, tables, ref64, torch, P=None):
    """The f32 engine's ``tables`` against the float64 tables ``ref64`` of
    the same zoo at the same points: plain rows per alpha relative to their
    max abs (F32_RTOL), macro rows per element / (max abs + 1)
    (F32_MACRO_TOL); fails past either, or on non-finite values.  With the
    points ``P``, macro rows are compared where the float32 binning puts a
    point in the same subcells as the float64 one (``same_subcells``)."""
    if not all(bool(torch.isfinite(t).all()) for t in tables.values()):
        fail(f"{name}: non-finite values in the tables")
    pr = tab.plain_rows
    worst, zoo_err, zoo_max = 0.0, 0.0, 0.0
    for a in tab.alphas:
        d = (tables[a][:pr].double() - ref64[a][:pr]).abs()
        err, scale = d.max().item(), ref64[a][:pr].abs().max().item()
        row = int(d.max(dim=1).values.argmax().item())
        el = next(i for i, (lo, hi, _) in enumerate(tab.slices) if lo <= row < hi)
        print(f"{name} vs f64 plain rows {a}: max abs {err:.3e} / max {scale:.3e} = "
              f"{err / scale:.3e} (worst {type(zoo[el]).__name__} #{el})")
        worst = max(worst, err / scale)
        zoo_err, zoo_max = max(zoo_err, err), max(zoo_max, scale)
        if not err / scale <= F32_RTOL:
            fail(f"{name} plain rows {a}: {err / scale:.3e} > {F32_RTOL} at "
                 f"{type(zoo[el]).__name__} #{el}")
    macro_worst, keep = 0.0, slice(None)
    if P is not None:
        keep = merged_macro(tab).same_subcells(P)
        print(f"{name}: {int((~keep).sum())} of {keep.numel()} points lie within the float32 "
              f"binning tolerance of an interior face, where float32 averages over the subcells "
              f"that meet and float64 does not; macro rows compared on the other "
              f"{int(keep.sum())}")
    for i in range(len(zoo)):
        lo, hi, _ = tab.slices[i]
        if lo < pr:
            continue
        for a in tab.alphas:
            ref = ref64[a][lo:hi, keep]
            err = (tables[a][lo:hi, keep].double() - ref).abs().max().item()
            rel = err / (ref.abs().max().item() + 1.0)
            macro_worst = max(macro_worst, rel)
            if not rel <= F32_MACRO_TOL:
                fail(f"{name} macro rows {type(zoo[i]).__name__} {a}: {rel:.3e} > "
                     f"{F32_MACRO_TOL}")
    print(f"{name} vs f64 on all {NPTS} points: zoo-wide plain rows {zoo_err / zoo_max:.3e} "
          f"(worst alpha {worst:.3e}, limit {F32_RTOL}); macro rows {macro_worst:.3e} "
          f"(limit {F32_MACRO_TOL})")


def k7_on_k3_arrays(name, mo, phi, P, dev, torch):
    """K7 (csrc/masked_matmul.cu) on K3's merged triangle arrays, reading
    the zoo's K1 Phi ``phi`` by prefix: held to K3 (KERNEL_RTOL), and its
    ms, Phi given, a second yardstick of K3 beside the DGEMM on the masked
    B."""
    from fiat_tpu_torch.ops.masked_matmul import MaskedMatmul
    k7 = MaskedMatmul(mo.A.cpu().numpy(), list(enumerate(mo.nexp)), mo.geom, mo.parent_map,
                      device=dev)
    err, rel = rel_err(k7(P, phi), mo(P))
    print(f"{name}: K7 on K3's macro arrays ({k7.rows} x {k7.K}, sd 2) vs K3: max abs {err:.3e}, "
          f"rel {rel:.3e}")
    if not rel <= KERNEL_RTOL:
        fail(f"{name}: K7 disagrees with K3 on its macro arrays: rel {rel:.3e} > {KERNEL_RTOL}")
    return median_ms(lambda: k7(P, phi), torch)


def masked_gemm_ms(mo, P, torch):
    """One cuBLAS GEMM (DGEMM, or SGEMM with TF32 off) of K3's merged A by
    the masked parent basis B of its plain version, computed beforehand:
    the library yardstick of K3."""
    from fiat_tpu_torch.ops.kernels import no_tf32
    B = mo.operand(P)[0]
    with no_tf32():
        ms = median_ms(lambda: torch.matmul(mo.A, B), torch)
    del B
    return ms


def tet_zoos(T3):
    """bench.py's tet_lagrange8 (:793-795) and hdiv_hcurl_tet (:809-818)."""
    import fiat_tpu_torch as ft
    return ([ft.Lagrange(T3, 8)],
            [ft.RaviartThomas(T3, k) for k in range(1, 4)]
            + [ft.Nedelec(T3, k) for k in range(1, 4)]
            + [ft.BrezziDouglasMarini(T3, k) for k in range(1, 4)])


def tet_phase(dev, card, torch, np):
    """Phase 5: tet_lagrange8 on K1 (sd = 3) + K2 (K = 165) and on K8 + K2,
    hdiv_hcurl_tet on K1 + K2, at bench.py's pts3; one launch of each
    kernel of a route per pass."""
    from fiat_tpu_torch import device_tabulator, ufc_simplex
    from fiat_tpu_torch.ops.fused_zoo import FusedZooTabulator
    from fiat_tpu_torch.ops.tabulate import BatchedTabulator

    pts3 = make_points(NPTS, SEED, np, sd=3)
    P = torch.as_tensor(pts3, device=dev)
    t0 = time.perf_counter()
    lag8, hdiv = tet_zoos(ufc_simplex(3))
    tab = device_tabulator(lag8, order=1)          # the default device: the card
    bern = FusedZooTabulator(BatchedTabulator(lag8, order=1, device="cpu"), features="bernstein")
    htab = device_tabulator(hdiv, order=1)
    if not tab.device == bern.device == htab.device == dev:
        fail(f"tet engines on {tab.device}, {bern.device}, {htab.device}, not {dev}")
    rec, mm, feat, bmm = tab.recurrence, tab.matmul, bern.features, bern.matmul
    hrec, hmm = htab.recurrence, htab.matmul
    print(f"tet host construction: tet_lagrange8 {tab.rows} rows x {len(tab.alphas)} alphas, "
          f"K {mm.max_k}; hdiv_hcurl_tet {len(hdiv)} elements, {htab.rows} rows x "
          f"{len(htab.alphas)} alphas, widths {htab.widths}; Bernstein route (conversion "
          f"folded into K2's rows) included; {time.perf_counter() - t0:.2f} s")

    phi_p = rec.plain(P)
    k1_abs = check_kernel(f"tet_lagrange8 K1 recurrence (sd 3, degree {rec.degree}) at {NPTS} "
                          f"points", rec(P), phi_p, torch)
    k2_abs = check_kernel(f"tet_lagrange8 K2 bucket matmul ({mm.total_rows} x {NPTS}, K "
                          f"{mm.max_k})", mm(phi_p), mm.plain(phi_p), torch)
    del phi_p
    b_p = feat.plain(P)
    k8_abs = check_kernel(f"K8 Bernstein features (sd 3, degree {feat.degree}) at {NPTS} points",
                          feat(P), b_p, torch)
    bk2_abs = check_kernel(f"tet_lagrange8 Bernstein route K2 ({bmm.total_rows} x {NPTS}, K "
                           f"{bmm.max_k})", bmm(b_p), bmm.plain(b_p), torch)
    del b_p
    hphi_p = hrec.plain(P)
    check_kernel(f"hdiv_hcurl_tet K1 recurrence (sd 3, degree {hrec.degree})", hrec(P), hphi_p,
                 torch)
    hk2_abs = check_kernel(f"hdiv_hcurl_tet K2 bucket matmul ({hmm.total_rows} x {NPTS}, widths "
                           f"{hmm.K})", hmm(hphi_p), hmm.plain(hphi_p), torch)
    del hphi_p

    routes = {"tet_lagrange8": (tab, lag8, {"K1": rec, "K2": mm}),
              "tet_lagrange8 bernstein": (bern, lag8, {"K8": feat, "K2": bmm}),
              "hdiv_hcurl_tet": (htab, hdiv, {"K1": hrec, "K2": hmm})}
    launches, host = {}, {}
    for name, (t, zoo, engines) in routes.items():
        launches[name], host[name] = run_main_path(name, t, zoo, pts3, torch, np, engines)
        if launches[name] != {k: 1 for k in engines}:
            fail(f"{name}: one pass must launch each of {sorted(engines)} once: {launches[name]}")

    phi, feats, hphi = rec(P), feat(P), hrec(P)
    k1_ms, k1_plain = median_ms(lambda: rec(P), torch), median_ms(lambda: rec.plain(P), torch)
    k8_ms, k8_plain = median_ms(lambda: feat(P), torch), median_ms(lambda: feat.plain(P), torch)
    k2_ms, k2_plain = median_ms(lambda: mm(phi), torch), median_ms(lambda: mm.plain(phi), torch)
    A, bA, hA = mm.A.to(phi.device), bmm.A.to(phi.device), hmm.A.to(phi.device)
    k2_lib = median_ms(lambda: torch.matmul(A, phi), torch)     # one cuBLAS DGEMM
    bk2_ms, bk2_plain = median_ms(lambda: bmm(feats), torch), median_ms(lambda: bmm.plain(feats),
                                                                      torch)
    bk2_lib = median_ms(lambda: torch.matmul(bA, feats), torch)
    hk1_ms = median_ms(lambda: hrec(P), torch)
    hk2_ms, hk2_plain = median_ms(lambda: hmm(hphi), torch), median_ms(lambda: hmm.plain(hphi),
                                                                     torch)
    hk2_lib = median_ms(lambda: torch.matmul(hA, hphi[:hmm.max_k]), torch)
    del phi, feats, hphi, A, bA, hA
    path = {name: median_ms(lambda t=t: t.block_tables(P), torch)
            for name, (t, _, _) in routes.items()}
    plain = {"tet_lagrange8": median_ms(lambda: mm.plain(rec.plain(P)), torch),
             "tet_lagrange8 bernstein": median_ms(lambda: bmm.plain(feat.plain(P)), torch),
             "hdiv_hcurl_tet": median_ms(lambda: hmm.plain(hrec.plain(P)), torch)}
    for name, (t, _, _) in routes.items():
        gbytes = t.matmul.total_rows * NPTS * 8 / 1e9
        print(f"{name} timing ({card}; median of {REPS} runs of {INNER}, CUDA events): pass "
              f"{path[name]:.4f} ms, plain path {plain[name]:.4f} ms; a pass writes "
              f"{gbytes:.3f} GB = {gbytes / path[name]:.3f} TB/s; host error "
              f"{host[name]:.3e}")
    print(f"tet kernels ({card}; CUDA events): K1 sd 3 degree 8 {k1_ms:.4f} ms (plain "
          f"{k1_plain:.4f}); K8 {k8_ms:.4f} ms (plain {k8_plain:.4f}); faster B operand: "
          f"{'K8' if k8_ms < k1_ms else 'K1'} by {max(k1_ms, k8_ms) / min(k1_ms, k8_ms):.2f}x; "
          f"K2 K 165 {k2_ms:.4f} ms = {k2_rates(mm, k2_ms)} (plain {k2_plain:.4f}, cuBLAS DGEMM "
          f"{k2_lib:.4f}), on the Bernstein route {bk2_ms:.4f} ms = {k2_rates(bmm, bk2_ms)} "
          f"(plain {bk2_plain:.4f}, DGEMM {bk2_lib:.4f}); hdiv_hcurl_tet K1 {hk1_ms:.4f} ms, K2 "
          f"{hk2_ms:.4f} ms = {k2_rates(hmm, hk2_ms)} (plain {hk2_plain:.4f}, one padded DGEMM "
          f"{hk2_lib:.4f})")

    src = "fiat_tpu_torch/csrc/"
    engines64 = {"tet_lagrange8": tab, "hdiv_hcurl_tet": htab}
    return engines64, [
        entry("K1 dubiner3_values (tet_lagrange8)", src + "recurrence.cu",
              "fiat_tpu/ops/pallas_recurrence.py:399", launches["tet_lagrange8"]["K1"], k1_abs,
              k1_ms, k1_plain, rec_bound(rec, NPTS)),
        entry("K2 bucket_matmul (tet_lagrange8, K 165)", src + "bucket_matmul.cu",
              "fiat_tpu/ops/pallas_multiword.py:269", launches["tet_lagrange8"]["K2"], k2_abs,
              k2_ms, k2_plain, matmul_bound(mm, NPTS), k2_lib),
        entry("K8 bernstein_features (tet_lagrange8)", src + "bernstein.cu",
              "fiat_tpu/ops/pallas_bernstein.py:288", launches["tet_lagrange8 bernstein"]["K8"],
              k8_abs, k8_ms, k8_plain, features_bound(feat, NPTS)),
        entry("K2 bucket_matmul (tet_lagrange8 bernstein, K 165)", src + "bucket_matmul.cu",
              "fiat_tpu/ops/pallas_multiword.py:269", launches["tet_lagrange8 bernstein"]["K2"],
              bk2_abs, bk2_ms, bk2_plain, matmul_bound(bmm, NPTS), bk2_lib),
        entry("K2 bucket_matmul (hdiv_hcurl_tet)", src + "bucket_matmul.cu",
              "fiat_tpu/ops/pallas_multiword.py:269", launches["hdiv_hcurl_tet"]["K2"], hk2_abs,
              hk2_ms, hk2_plain, matmul_bound(hmm, NPTS), hk2_lib),
    ]


def sv_macro_tet(T3):
    """The Scott-Vogelius velocity/pressure pairs on barycentrically refined
    tetrahedral meshes: P3 / DG2 on Alfeld splits, P2 / DG1 on Worsey-Farin
    splits, beside the unsplit P1 and P3."""
    import fiat_tpu_torch as ft
    return [ft.Lagrange(T3, 1), ft.Lagrange(T3, 3), ft.Lagrange(T3, 3, variant="alfeld"),
            ft.DiscontinuousLagrange(T3, 2, variant="alfeld"),
            ft.Lagrange(T3, 2, variant="worsey-farin"),
            ft.DiscontinuousLagrange(T3, 1, variant="worsey-farin")]


def masked_bound(k7, npts):
    """K7: the points, Phi's prefix and A in, the tables out; per point and
    program, its rows against the one subcell an interior point bins into.
    A matrix product once points are grouped by subcell, so the FP64
    tensor-core rate, as K2's."""
    flops = sum(2 * (g["rows"][1] - g["rows"][0]) * nexp
                for g, nexp in one_piece_nexp(k7.geom, k7.nexp))
    nbytes = 8 * (npts * (k7.sd + k7.max_nexp) + k7.A.numel() + k7.rows * npts)
    return bound_of(nbytes, flops * npts, FP64_MMA_MS)


def dg6_worsey_farin(T3):
    """Lagrange 1 beside DiscontinuousLagrange 6 on the Worsey-Farin split:
    K7's row chunks of 274,176 bytes, past a block's shared memory."""
    import fiat_tpu_torch as ft
    return [ft.Lagrange(T3, 1), ft.DiscontinuousLagrange(T3, 6, variant="worsey-farin")]


def k7_plan_line(name, k7):
    """K7's plan and, from the CUDA runtime, the blocks an SM that its
    registers and shared memory allow; fails below the plan's blocks."""
    from fiat_tpu_torch.ops.masked_matmul import COLUMN_STRIDE
    tp, cols, stages, blocks = k7.plan
    resident = k7.occupancy()
    print(f"{name} K7 plan: {tp}-point tiles (two threads a point), slices of {cols} columns "
          f"({cols * COLUMN_STRIDE * 8} bytes; the widest chunk {k7.chunk_cols}) in a ring of "
          f"{stages}, {blocks} blocks an SM "
          f"planned, {resident} resident ({k7.smem} bytes of shared memory a block, Phi prefix "
          f"{k7.max_nexp} x {tp}; {k7.slices.shape[0]} slices of {k7.chunks.shape[0]} row chunks)")
    if resident < blocks:
        fail(f"{name}: K7 holds {resident} blocks an SM, its plan {k7.plan} needs {blocks}")


def masked_scale(k7, P, phi):
    """max of |A| |B|, B the masked basis: the scale of K7's rounding where
    its sums cancel (A's entries reach 5.2e5 on Worsey-Farin DG 6)."""
    return (k7.A.abs() @ k7.masked_basis(k7.masks(P)[0], phi).abs()).max().item()


def dg6_phase(P, pts3, card, torch, np):
    """Phase 6, second part: the zoo past K7's old shared-memory ceiling
    (``dg6_worsey_farin``) on K1, K2 and K7, one launch each a pass; K7
    against its plain version relative to |A| |B|, the tables against host
    per alpha relative to max(1, max |table|) (degree 6's change of basis
    leaves fiat_tpu's own engine 2.1e-10 of that from host on these points'
    values)."""
    from fiat_tpu_torch import device_tabulator, ufc_simplex

    t0 = time.perf_counter()
    zoo = dg6_worsey_farin(ufc_simplex(3))
    tab = device_tabulator(zoo, order=1)
    rec, mm, k7 = tab.recurrence, tab.matmul, merged_macro(tab)
    print(f"dg6_worsey_farin host construction: K7 {k7.rows} x {k7.K} over {len(k7.nexp)} "
          f"subcells, {time.perf_counter() - t0:.2f} s")
    k7_plan_line("dg6_worsey_farin", k7)
    if k7.plan[1] >= k7.chunk_cols:
        fail("dg6_worsey_farin: K7's slices must cut its chunks")
    phi = rec(P)
    err = (k7(P, phi) - k7.plain(P, phi)).abs().max().item()
    rel = err / masked_scale(k7, P, phi)
    print(f"dg6_worsey_farin K7 ({k7.rows} x {NPTS}) vs plain: max abs {err:.3e}, rel to |A| |B| "
          f"{rel:.3e}")
    if not rel <= KERNEL_RTOL:
        fail(f"dg6_worsey_farin: K7 disagrees with its plain version: {rel:.3e} > {KERNEL_RTOL}")
    blocks, launches = counted({"K1": rec, "K2": mm, "K7": k7}, lambda: tab.block_tables(P),
                               torch)
    expect_launches("dg6_worsey_farin", launches, {"K1": 1, "K2": 1, "K7": 1})
    if not all(bool(torch.isfinite(b).all()) for bl in blocks.values() for b in bl):
        fail("dg6_worsey_farin: non-finite values in the tables")
    worst = 0.0
    for el, got in zip(zoo, tab.unpack(blocks)):
        for a, w in el.tabulate(1, pts3[:HOST_CHECK_PTS]).items():
            d = np.abs(got[a][..., :HOST_CHECK_PTS].cpu().numpy() - w).max()
            worst = max(worst, float(d) / max(1.0, float(np.abs(w).max())))
    del blocks
    print(f"dg6_worsey_farin vs host el.tabulate on {HOST_CHECK_PTS} points: {worst:.3e} of "
          f"max(1, max |table|) per alpha (limit {DG6_HOST_RTOL})")
    if not worst <= DG6_HOST_RTOL:
        fail(f"dg6_worsey_farin disagrees with host: {worst:.3e} > {DG6_HOST_RTOL}")
    ms, plain = median_ms(lambda: k7(P, phi), torch), median_ms(lambda: k7.plain(P, phi), torch)
    B, A = k7.masked_basis(k7.masks(P)[0], phi), k7.A.to(P.device)
    lib = median_ms(lambda: torch.matmul(A, B), torch)
    del B, A, phi
    path_ms = median_ms(lambda: tab.block_tables(P), torch)
    bound = masked_bound(k7, NPTS)
    print(f"dg6_worsey_farin timing ({card}; median of {REPS} runs of {INNER}, CUDA events): pass "
          f"{path_ms:.4f} ms; K7 {ms:.4f} ms (plain {plain:.4f}, one DGEMM on the masked B "
          f"{lib:.4f}, bound {bound[0]:.4f} by {bound[1]})")
    return entry("K7 masked_matmul (Worsey-Farin DG 6, slices past a block's shared memory)",
                 "fiat_tpu_torch/csrc/masked_matmul.cu", "fiat_tpu/ops/pallas_multiword.py:440",
                 launches["K7"], err, ms, plain, bound, lib)


def sv_phase(dev, card, torch, np):
    """Phase 6: sv_macro_tet on K1 (sd = 3), K2 and K7, one launch each per
    pass, at bench.py's pts3; K7 against its plain version on the same Phi
    and points (phases 2 and 9 hold it against K3 on triangles)."""
    from fiat_tpu_torch import device_tabulator, ufc_simplex

    pts3 = make_points(NPTS, SEED, np, sd=3)
    P = torch.as_tensor(pts3, device=dev)
    t0 = time.perf_counter()
    zoo = sv_macro_tet(ufc_simplex(3))
    tab = device_tabulator(zoo, order=1)          # the default device: the card
    rec, mm, k7 = tab.recurrence, tab.matmul, merged_macro(tab)
    if tab.device != dev or k7 is None or k7.name != "K7":
        fail(f"sv_macro_tet: the macro elements must run on K7 on {dev}, got "
             f"{getattr(k7, 'name', None)} on {tab.device}")
    print(f"sv_macro_tet host construction: {len(zoo)} elements, {mm.total_rows} plain rows in "
          f"widths {tab.widths}, K7 {k7.rows} x {k7.K} over {len(k7.nexp)} subcells in "
          f"{len(k7.geom)} programs ({k7.chunks.shape[0]} row chunks), K1 degree {rec.degree}, "
          f"{time.perf_counter() - t0:.2f} s")
    k7_plan_line("sv_macro_tet", k7)

    phi_p = rec.plain(P)
    check_kernel(f"sv_macro_tet K1 recurrence (sd 3, degree {rec.degree})", rec(P), phi_p, torch)
    check_kernel(f"sv_macro_tet K2 bucket matmul ({mm.total_rows} x {NPTS})", mm(phi_p),
                 mm.plain(phi_p), torch)
    k7_abs = check_kernel(f"sv_macro_tet K7 masked matmul ({k7.rows} x {NPTS})", k7(P, phi_p),
                          k7.plain(P, phi_p), torch)
    del phi_p

    engines = {"K1": rec, "K2": mm, "K7": k7}
    launches, host_err = run_main_path("sv_macro_tet", tab, zoo, pts3, torch, np, engines)
    if launches != {"K1": 1, "K2": 1, "K7": 1}:
        fail(f"sv_macro_tet: one pass must launch K1, K2 and K7 once each: {launches}")

    phi = rec(P)
    k7_ms, k7_plain = median_ms(lambda: k7(P, phi), torch), median_ms(lambda: k7.plain(P, phi),
                                                                     torch)
    B = k7.masked_basis(k7.masks(P)[0], phi)
    A = k7.A.to(dev)
    k7_lib = median_ms(lambda: torch.matmul(A, B), torch)       # one DGEMM, B given
    k1_ms, k2_ms = median_ms(lambda: rec(P), torch), median_ms(lambda: mm(phi), torch)
    del phi, B, A
    path_ms = median_ms(lambda: tab.block_tables(P), torch)

    def plain_path():
        phi = rec.plain(P)
        return mm.plain(phi), k7.plain(P, phi)

    plain_ms = median_ms(plain_path, torch)
    bound = masked_bound(k7, NPTS)
    gbytes = (mm.total_rows + k7.rows) * NPTS * 8 / 1e9
    print(f"sv_macro_tet timing ({card}; median of {REPS} runs of {INNER}, CUDA events): pass "
          f"{path_ms:.4f} ms, plain path {plain_ms:.4f} ms; K1 {k1_ms:.4f} ms, K2 {k2_ms:.4f} ms "
          f"= {k2_rates(mm, k2_ms)}, K7 {k7_ms:.4f} ms (plain {k7_plain:.4f}, one DGEMM on the "
          f"masked B "
          f"{k7_lib:.4f}, bound {bound[0]:.4f} by {bound[1]}); a pass writes {gbytes:.3f} GB "
          f"= {gbytes / path_ms:.3f} TB/s; host error {host_err:.3e}")
    return tab, [entry("K7 masked_matmul (sv_macro_tet)", "fiat_tpu_torch/csrc/masked_matmul.cu",
                       "fiat_tpu/ops/pallas_multiword.py:440", launches["K7"], k7_abs, k7_ms,
                       k7_plain, bound, k7_lib),
                 dg6_phase(P, pts3, card, torch, np)]


def tet_dual_f32_phase(dev, card, engines64, torch, np):
    """Phase 7: tetrahedra through dual evaluation (moments on K45's sd = 3
    stage, one launch; interpolation on K1, one launch, no K45; moments of
    sv_macro_tet on K45 alone, no K3) and through the f32 engine (K6's
    sd = 3 stage, one launch a pass, held against phase 5's float64
    tables ``engines64``), at bench.py's pts3."""
    from fiat_tpu_torch import device_tabulator, ufc_simplex
    from fiat_tpu_torch.ops import moments as mo
    from fiat_tpu_torch.ops.tabulate import BatchedTabulator

    pts3 = make_points(NPTS, SEED, np, sd=3)
    P = torch.as_tensor(pts3, device=dev)
    T3 = ufc_simplex(3)
    lag8, hdiv = tet_zoos(T3)
    zoos = {"tet_lagrange8": lag8, "hdiv_hcurl_tet": hdiv, "sv_macro_tet": sv_macro_tet(T3)}
    wf_h = np.random.default_rng(7).random(NPTS)      # bench.py:441
    wf = torch.as_tensor(wf_h, device=dev)
    src = "fiat_tpu_torch/csrc/"
    k45_replaces = "fiat_tpu/ops/pallas_recurrence.py:549, fiat_tpu/ops/pallas_recurrence.py:727"
    kernels = []

    for name, zoo in zoos.items():
        t0 = time.perf_counter()
        bt = BatchedTabulator(zoo, order=0)     # the default device: the card
        eng = mo.moment_engine(bt)
        pm, rec = eng.moments, eng.recurrence
        macro = name == "sv_macro_tet"
        if eng.device != dev or pm.sd != 3:
            fail(f"{name}: the moments engine must run K45's sd = 3 stage on {dev}")
        if macro and (pm.rows, len(pm.piece_nexp), len(pm.geom)) != (308, 32, 4):
            fail(f"sv_macro_tet: K45 must sum 308 rows over 32 subcells in 4 programs, got "
                 f"{pm.rows} over {len(pm.piece_nexp)} in {len(pm.geom)}")
        print(f"{name} dual host construction: {len(zoo)} elements, {eng.rows} rows, K45 "
              f"{pm.rows} sums (degree {pm.degree}: {pm.nplain} plain + {pm.rows - pm.nplain} "
              f"masked over {len(pm.piece_nexp)} subcells), {time.perf_counter() - t0:.2f} s")
        k45_abs = check_kernel(f"{name} K45 sd 3 ({pm.rows} sums over {NPTS} points)",
                               pm(P, wf), pm.plain(P, wf), torch)
        check_k45_alone(name, pm, P, wf, torch)

        engines = {"K45": pm, "K1": rec}
        M, launches = counted(engines, lambda: mo.moment_rows(bt, P, wf), torch)
        expect_launches(f"{name} moments", launches, {"K45": 1, "K1": 0})
        k45_launches = launches["K45"]
        c_h = np.random.default_rng(11).random(eng.rows) - 0.5
        c = u = None
        if macro:
            if eng.built["macro"]:
                fail("sv_macro_tet: moments must not build K3")
        else:
            c = torch.as_tensor(c_h, device=dev)
            u, launches = counted(engines, lambda: mo.interpolate_rows(bt, P, c), torch)
            expect_launches(f"{name} interpolation", launches, {"K45": 0, "K1": 1})
            if tuple(u.shape) != (NPTS,) or not bool(torch.isfinite(u).all()):
                fail(f"{name}: interpolation {tuple(u.shape)}, finite "
                     f"{bool(torch.isfinite(u).all())}")
        if tuple(M.shape) != (eng.rows,) or not bool(torch.isfinite(M).all()):
            fail(f"{name}: moments {tuple(M.shape)}, finite {bool(torch.isfinite(M).all())}")
        host_dual_check(name, zoo, bt, mo, P, pts3, wf, wf_h, u, c_h, np)

        mom_ms = median_ms(lambda: mo.moment_rows(bt, P, wf), torch)
        int_ms = None if macro else median_ms(lambda: mo.interpolate_rows(bt, P, c), torch)
        k45_ms, k45_plain = median_ms(lambda: pm(P, wf), torch), median_ms(lambda: pm.plain(P, wf),
                                                                          torch)
        k45_lib = stack_mv_ms(pm, P, wf, torch)
        bound = moments_bound(pm, NPTS)
        print(f"{name} dual timing at {NPTS} points ({card}; median of {REPS} runs of {INNER}, "
              f"CUDA events): moment_rows {mom_ms:.4f} ms"
              + ("" if macro else f", interpolate_rows {int_ms:.4f} ms")
              + f"; K45 {k45_ms:.4f} ms (plain {k45_plain:.4f}, one DGEMV on its stack built "
              f"beforehand {k45_lib:.4f}, bound {bound[0]:.4f} by {bound[1]})")
        kernels.append(entry(f"K45 pair_moments sd 3 ({name})", src + "moments.cu",
                             k45_replaces, k45_launches, k45_abs, k45_ms, k45_plain, bound,
                             k45_lib))
        if name == "tet_lagrange8":
            # 1e7 points: points and weights (320 MB) stream from HBM; the
            # plain version runs in slices of 1e6 (its Phi alone at 1e7 is 13 GB)
            big = torch.as_tensor(make_points(BIG_NPTS, SEED + 1, np, sd=3), device=dev)
            wbig = torch.as_tensor(np.random.default_rng(8).random(BIG_NPTS), device=dev)
            check_kernel(f"tet_lagrange8 K45 sd 3 ({pm.rows} sums over {BIG_NPTS} points)",
                         pm(big, wbig), plain_in_slices(pm, big, wbig), torch)
            big_ms = median_ms(lambda: pm(big, wbig), torch, reps=5, inner=4)
            big_bound = moments_bound(pm, BIG_NPTS)
            torch.cuda.reset_peak_memory_stats()
            big_lib = stack_mv_ms(pm, big, wbig, torch, reps=5, inner=4)
            print(f"tet_lagrange8 K45 sd 3 at {BIG_NPTS} points ({card}; CUDA events): "
                  f"{big_ms:.4f} ms (bound {big_bound[0]:.4f} by {big_bound[1]}, "
                  f"{big_ms / big_bound[0]:.1f}x; one DGEMV on its "
                  f"{pm.rows * BIG_NPTS * 8 / 1e9:.1f} GB stack built beforehand {big_lib:.4f}, "
                  f"peak memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB); "
                  f"{BIG_NPTS / big_ms / 1e6:.3f} Gpoints/s")
            del big, wbig
            torch.cuda.empty_cache()

    P32 = P.float()
    for name in ("tet_lagrange8", "hdiv_hcurl_tet"):
        zoo = zoos[name]
        t0 = time.perf_counter()
        tab = device_tabulator(zoo, order=1, f64=False)   # the default device: the card
        k6 = tab.kernel
        if tab.device != dev or k6.sd != 3 or merged_macro(tab) is not None:
            fail(f"{name} f32: K6's sd = 3 stage alone on {dev}")
        print(f"{name} f32 host construction: {tab.rows} rows x {len(tab.alphas)} alphas, K6 "
              f"{k6.total_rows} rows in widths {k6.K}, {time.perf_counter() - t0:.2f} s")
        k6_plan_line(name, k6)
        shape = (k6.total_rows, NPTS)
        k6_abs = check_kernel(f"{name} K6 sd 3 ({k6.total_rows} x {NPTS})",
                              k6(P32, tab.dst_plain, torch.empty(shape, device=dev)),
                              k6.plain(P32, tab.dst_plain, torch.empty(shape, device=dev)),
                              torch, F32_KERNEL_RTOL)
        tables, launches = counted({"K6": k6}, lambda: tab.tables(P), torch)
        expect_launches(f"{name} f32", launches, {"K6": 1})
        if not all(bool(torch.isfinite(t).all()) for t in tables.values()):
            fail(f"{name} f32: non-finite values in the tables")
        ref64 = engines64[name](P)
        worst = 0.0
        for a in tab.alphas:
            err = (tables[a].double() - ref64[a]).abs().max().item()
            rel = err / ref64[a].abs().max().item()
            worst = max(worst, rel)
            if not rel <= F32_RTOL:
                fail(f"{name} f32 {a}: {rel:.3e} of the alpha's max > {F32_RTOL}")
        print(f"{name} f32 vs phase 5's f64 tables on all {NPTS} points: worst alpha "
              f"{worst:.3e} of its max abs (limit {F32_RTOL})")
        del tables, ref64

        out = torch.empty(shape, device=dev)
        k6_ms = median_ms(lambda: k6(P32, tab.dst_plain, out), torch)
        k6_plain = median_ms(lambda: k6.plain(P32, tab.dst_plain, out), torch)
        k6_lib = zoo_f32_library_ms(k6, P32, torch)
        del out
        path_ms = median_ms(lambda: tab.tables(P), torch)
        bound = zoo_f32_bound(k6, NPTS)
        gbytes = k6.total_rows * NPTS * 4 / 1e9
        print(f"{name} f32 timing ({card}; median of {REPS} runs of {INNER}, CUDA events): "
              f"tables {path_ms:.4f} ms; K6 {k6_ms:.4f} ms (plain {k6_plain:.4f}, one padded "
              f"SGEMM on a computed Phi {k6_lib:.4f}, bound {bound[0]:.4f} by {bound[1]}); K6 "
              f"writes {gbytes:.3f} GB = {gbytes / k6_ms:.3f} TB/s")
        kernels.append(entry(f"K6 zoo_f32 sd 3 ({name})", src + "zoo_f32.cu",
                             "fiat_tpu/ops/pallas_tabulate.py:248", launches["K6"], k6_abs,
                             k6_ms, k6_plain, bound, k6_lib))
    return kernels


def tet_macro_phase(dev, card, sv_tab, torch, np):
    """Phase 8: sv_macro_tet on K3's sd = 3 stage at bench.py's pts3:
    ``interpolate_rows`` (K1 + K3, one launch each a pass, no K45), the f32
    ``tables`` (K6 + K3 float32, one launch each, held against phase 6's f64
    tables of the engine ``sv_tab``), K3 against its plain version in f64
    and float32, and K3 against K7 on the f64 engine's merged arrays, both
    timed."""
    from fiat_tpu_torch import device_tabulator, ufc_simplex
    from fiat_tpu_torch.ops import moments as mo
    from fiat_tpu_torch.ops.macro_oneshot import MacroOneShot
    from fiat_tpu_torch.ops.tabulate import BatchedTabulator

    pts3 = make_points(NPTS, SEED, np, sd=3)
    P = torch.as_tensor(pts3, device=dev)
    zoo = sv_macro_tet(ufc_simplex(3))
    src, replaces = "fiat_tpu_torch/csrc/macro_oneshot.cu", "fiat_tpu/ops/pallas_multiword.py:652"

    # interpolation: K1 for the plain rows, K3 on one folded row per program
    t0 = time.perf_counter()
    bt = BatchedTabulator(zoo, order=0)     # the default device: the card
    eng = mo.moment_engine(bt)
    rec, m3 = eng.recurrence, merged_macro(eng)
    if eng.device != dev or m3 is None or m3.sd != 3:
        fail(f"sv_macro_tet interpolation must run K3's sd = 3 stage on {dev}")
    print(f"sv_macro_tet interpolation host construction: {eng.rows} rows, K1 degree "
          f"{rec.degree}, K3 sd 3 over {len(m3.geom)} programs x {m3.K} columns in "
          f"{len(m3.nexp)} subcells ({m3.chunks_one.shape[0]} one-row chunks), "
          f"{time.perf_counter() - t0:.2f} s")
    c_h = np.random.default_rng(11).random(eng.rows) - 0.5
    c = torch.as_tensor(c_h, device=dev)
    W = eng.program_columns[0] * (c @ eng.matrix)[eng.nexp:]
    w_abs = check_kernel(f"sv_macro_tet K3 sd 3 one row per program ({W.shape[0]} x "
                         f"{W.shape[1]}, interpolation)", m3(P, A=W), m3.plain(P, A=W), torch)
    u, launches = counted({"K1": rec, "K3": m3}, lambda: mo.interpolate_rows(bt, P, c), torch)
    expect_launches("sv_macro_tet interpolation", launches, {"K1": 1, "K3": 1})
    w_launches = launches["K3"]
    if eng.built["moments"]:
        fail("sv_macro_tet: interpolation must not build K45")
    if tuple(u.shape) != (NPTS,) or not bool(torch.isfinite(u).all()):
        fail(f"sv_macro_tet interpolation {tuple(u.shape)}, finite {bool(torch.isfinite(u).all())}")
    n = HOST_CHECK_PTS
    host_u = np.zeros(n)
    for el, (lo, hi, _) in zip(zoo, bt.slices):
        host_u += c_h[lo:hi] @ np.asarray(el.tabulate(0, pts3[:n])[(0, 0, 0)]).reshape(hi - lo, n)
    int_err = float(np.abs(u[:n].cpu().numpy() - host_u).max())
    print(f"sv_macro_tet interpolation vs host el.tabulate(0) on {n} points: max abs "
          f"{int_err:.3e}")
    if not int_err <= HOST_ATOL:
        fail(f"sv_macro_tet interpolation: {int_err:.3e} > {HOST_ATOL}")

    def interp_plain():
        folded = c @ eng.matrix
        return (folded[:eng.nexp] @ rec.plain(P)
                + m3.plain(P, A=eng.program_columns[0] * folded[eng.nexp:]).sum(dim=0))

    int_ms, int_plain = median_ms(lambda: mo.interpolate_rows(bt, P, c), torch), median_ms(
        interp_plain, torch)
    w_ms, w_plain = median_ms(lambda: m3(P, A=W), torch), median_ms(lambda: m3.plain(P, A=W),
                                                                  torch)
    B = m3.operand(P)[0]
    w_lib = median_ms(lambda: torch.matmul(W, B), torch)      # one DGEMM, B given
    del B
    w_bound = macro_bound(m3, NPTS, one_row=True)
    print(f"sv_macro_tet interpolation timing ({card}; median of {REPS} runs of {INNER}, CUDA "
          f"events): interpolate_rows {int_ms:.4f} ms (plain {int_plain:.4f}); K3 sd 3 one row "
          f"per program {w_ms:.4f} ms (plain {w_plain:.4f}, one DGEMM on the masked B "
          f"{w_lib:.4f}, bound {w_bound[0]:.4f} by {w_bound[1]})")

    # the f32 tables: K6's sd = 3 stage for the plain rows, K3 float32 for the macro rows
    t0 = time.perf_counter()
    tab = device_tabulator(zoo, order=1, f64=False)   # the default device: the card
    k6, m3f = tab.kernel, merged_macro(tab)
    if tab.device != dev or k6.sd != 3 or m3f is None or m3f.sd != 3:
        fail(f"sv_macro_tet f32: K6's and K3's sd = 3 stages on {dev}")
    print(f"sv_macro_tet f32 host construction: K6 {k6.total_rows} rows in widths {k6.K}, K3 "
          f"float32 sd 3 {m3f.rows} x {m3f.K} ({m3f.chunks.shape[0]} row chunks, "
          f"{m3f.smem} bytes of shared memory a block), {time.perf_counter() - t0:.2f} s")
    k6_plan_line("sv_macro_tet f32", k6)
    P32 = P.float()
    shape = (k6.total_rows, NPTS)
    k6_abs = check_kernel(f"sv_macro_tet K6 sd 3 ({k6.total_rows} x {NPTS})",
                          k6(P32, tab.dst_plain, torch.empty(shape, device=dev)),
                          k6.plain(P32, tab.dst_plain, torch.empty(shape, device=dev)), torch,
                          F32_KERNEL_RTOL)
    f_abs = check_kernel(f"sv_macro_tet K3 float32 sd 3 ({m3f.rows} x {NPTS})", m3f(P32),
                         m3f.plain(P32), torch, F32_KERNEL_RTOL)
    tables, launches = counted({"K6": k6, "K3 float32": m3f}, lambda: tab.tables(P), torch)
    expect_launches("sv_macro_tet f32", launches, {"K6": 1, "K3 float32": 1})
    f_launches, k6_launches = launches["K3 float32"], launches["K6"]
    f32_vs_f64("sv_macro_tet f32", tab, zoo, tables, sv_tab(P), torch, P)
    del tables
    path_ms = median_ms(lambda: tab.tables(P), torch)
    f_ms, f_plain = median_ms(lambda: m3f(P32), torch), median_ms(lambda: m3f.plain(P32), torch)
    f_lib = masked_gemm_ms(m3f, P32, torch)
    f_bound = macro_bound(m3f, NPTS, 4, FP32_FMA_MS)
    out = torch.empty(shape, device=dev)
    k6_ms = median_ms(lambda: k6(P32, tab.dst_plain, out), torch)
    k6_plain = median_ms(lambda: k6.plain(P32, tab.dst_plain, out), torch)
    del out
    k6_lib, k6_bound = zoo_f32_library_ms(k6, P32, torch), zoo_f32_bound(k6, NPTS)
    print(f"sv_macro_tet f32 timing ({card}; median of {REPS} runs of {INNER}, CUDA events): "
          f"tables {path_ms:.4f} ms; K3 float32 sd 3 {f_ms:.4f} ms (plain {f_plain:.4f}, one "
          f"SGEMM on the masked B {f_lib:.4f}, bound {f_bound[0]:.4f} by {f_bound[1]}); K6 sd 3 "
          f"{k6_ms:.4f} ms (plain {k6_plain:.4f}, one SGEMM on a computed Phi {k6_lib:.4f}, "
          f"bound {k6_bound[0]:.4f} by {k6_bound[1]}); a pass "
          f"writes {len(tab.alphas) * tab.rows * NPTS * 4 / 1e9:.3f} GB")

    # K3 against K7 on the f64 engine's merged arrays (632 x 288) and points
    k7, rec64 = merged_macro(sv_tab), sv_tab.recurrence
    k3 = MacroOneShot(k7.A.cpu().numpy(), list(enumerate(k7.nexp)), k7.geom, k7.parent_map,
                      rec64.degree, rec64.scale, (rec64.A, rec64.b), device=dev)
    out3 = k3(P)
    k3_abs = check_kernel(f"sv_macro_tet K3 sd 3 ({k3.rows} x {NPTS}, {k3.chunks.shape[0]} row "
                          f"chunks)", out3, k3.plain(P), torch)
    phi = rec64(P)
    err, rel = rel_err(out3, k7(P, phi))
    print(f"K3 sd 3 vs K7 on sv_macro_tet's f64 arrays ({k3.rows} x {k3.K}): max abs {err:.3e}, "
          f"rel {rel:.3e}")
    if not rel <= KERNEL_RTOL:
        fail(f"K3 sd 3 disagrees with K7 on sv_macro_tet: rel {rel:.3e} > {KERNEL_RTOL}")
    del out3
    k3_ms, k3_plain = median_ms(lambda: k3(P), torch), median_ms(lambda: k3.plain(P), torch)
    k7_ms, k1_ms = median_ms(lambda: k7(P, phi), torch), median_ms(lambda: rec64(P), torch)
    k3_lib = masked_gemm_ms(k3, P, torch)
    k3_bound = macro_bound(k3, NPTS)
    del phi
    print(f"K3 sd 3 vs K7 on sv_macro_tet ({card}; median of {REPS} runs of {INNER}, CUDA "
          f"events): K3 {k3_ms:.4f} ms (plain {k3_plain:.4f}, one DGEMM on the masked B "
          f"{k3_lib:.4f}, bound {k3_bound[0]:.4f} by {k3_bound[1]}); K7 {k7_ms:.4f} ms on K1's "
          f"Phi (K1 {k1_ms:.4f} ms); the f64 engine takes {merged_macro(sv_tab).name}")
    return [
        # the f64 sd = 3 kernel's main path is the interpolation (the f64
        # tables take K7): its launches there, its times on the tables' A
        entry("K3 macro_oneshot sd 3 (timed on sv_macro_tet's f64 tables, 632 x 288; main "
              "path: interpolation)", src, replaces, w_launches, k3_abs, k3_ms, k3_plain,
              k3_bound, k3_lib),
        entry("K3 macro_oneshot float32 sd 3 (sv_macro_tet)", src, replaces, f_launches, f_abs,
              f_ms, f_plain, f_bound, f_lib),
        entry("K3 macro_oneshot sd 3 (sv_macro_tet interpolation)", src, replaces, w_launches,
              w_abs, w_ms, w_plain, w_bound, w_lib),
        entry("K6 zoo_f32 sd 3 (sv_macro_tet)", "fiat_tpu_torch/csrc/zoo_f32.cu",
              "fiat_tpu/ops/pallas_tabulate.py:248", k6_launches, k6_abs, k6_ms, k6_plain,
              k6_bound, k6_lib),
    ]


def c1_phase(T, dev, pts2, P, card, torch, np):
    """Phase 9: bench.py's c1_macro_zoo and c1_macro_hessians (:825-837),
    the C1 elements plus PS6 and PS12 at order 1 and 2, and the same zoo at
    order 3 (K3's A 330 x 138, 355.8 KB in f64: past a block's 227 KB of
    shared memory, which only a row chunk of it must fit), on K1, K2 and
    K3's sd = 2 stage (21 subcells), one launch each a pass, held to host;
    K3 timed beside a DGEMM on its masked B and K7 on K1's Phi."""
    import fiat_tpu_torch as ft
    from fiat_tpu_torch import device_tabulator

    zoo = [ft.CubicHermite(T), ft.Morley(T), ft.Argyris(T, 5), ft.Bell(T),
           ft.HsiehCloughTocher(T, 3), ft.QuadraticPowellSabin6(T), ft.QuadraticPowellSabin12(T)]
    kernels = []
    for name, order in (("c1_macro_zoo", 1), ("c1_macro_hessians", 2),
                        ("c1_macro_zoo order 3", 3)):
        t0 = time.perf_counter()
        tab = device_tabulator(zoo, order=order, device=dev)
        rec, mm, mo = tab.recurrence, tab.matmul, merged_macro(tab)
        if mo is None or mo.name != "K3" or len(mo.nexp) != 21:
            fail(f"{name}: the macro elements must run on K3 over 21 subcells")
        print(f"{name} host construction: {len(zoo)} elements, order {order}, {tab.rows} rows x "
              f"{len(tab.alphas)} alphas, widths {tab.widths}, K3 {mo.rows} x {mo.K} "
              f"({mo.rows * mo.K * 8} bytes of A; {mo.chunks.shape[0]} row chunks, "
              f"{mo.smem} bytes of shared memory a block), {time.perf_counter() - t0:.2f} s")
        k3_abs = check_kernel(f"{name} K3 ({mo.rows} x {NPTS})", mo(P), mo.plain(P), torch)
        launches, host_err = run_main_path(name, tab, zoo, pts2, torch, np, order=order)
        if launches != {"K1": 1, "K2": 1, "K3": 1}:
            fail(f"{name}: one pass must launch K1, K2 and K3 once each: {launches}")
        path_ms = median_ms(lambda: tab.block_tables(P), torch)
        plain_ms = median_ms(lambda: (mm.plain(rec.plain(P)), mo.plain(P)), torch)
        k3_ms, k3_plain = median_ms(lambda: mo(P), torch), median_ms(lambda: mo.plain(P), torch)
        k3_lib = masked_gemm_ms(mo, P, torch)
        phi = rec(P)
        k7_ms = k7_on_k3_arrays(name, mo, phi, P, dev, torch)
        k2_ms = median_ms(lambda: mm(phi), torch)
        del phi
        bound = macro_bound(mo, NPTS)
        gbytes = (mm.total_rows + mo.rows) * NPTS * 8 / 1e9
        print(f"{name} timing ({card}; median of {REPS} runs of {INNER}, CUDA events): pass "
              f"{path_ms:.4f} ms, plain path {plain_ms:.4f} ms; K2 {k2_ms:.4f} ms = "
              f"{k2_rates(mm, k2_ms)}; K3 {k3_ms:.4f} ms (plain "
              f"{k3_plain:.4f}, one DGEMM on the masked B {k3_lib:.4f}, K7 on K1's Phi "
              f"{k7_ms:.4f}, bound {bound[0]:.4f} by {bound[1]}); a pass writes {gbytes:.3f} GB "
              f"= {gbytes / path_ms:.3f} TB/s; host error {host_err:.3e}")
        kernels.append(entry(f"K3 macro_oneshot ({name})", "fiat_tpu_torch/csrc/macro_oneshot.cu",
                             "fiat_tpu/ops/pallas_multiword.py:652", launches["K3"], k3_abs, k3_ms,
                             k3_plain, bound, k3_lib))
    return kernels


#: fiat_tpu's own instance list (tests/test_nodality_sweep.py, SPECS at
#: :36-115), cut to the families that need no macro polynomial set, no
#: pointwise dual and no tensor-product cell, on one cell, in SPECS order:
#: (family, degree, variant); the COMPOSITES (:147-169) on that cell follow
FAMILIES_TRI = (
    ("DiscontinuousTaylor", 0, None), ("DiscontinuousTaylor", 1, None),
    ("DiscontinuousTaylor", 2, None), ("DiscontinuousTaylor", 3, None),
    ("DiscontinuousTaylor", 4, None), ("CrouzeixRaviart", 1, None),
    ("CrouzeixRaviart", 1, "point"), ("CrouzeixRaviart", 3, None),
    ("CrouzeixRaviart", 3, "point"), ("CrouzeixRaviart", 5, None),
    ("CrouzeixRaviart", 5, "point"), ("NedelecSecondKind", 1, None),
    ("NedelecSecondKind", 1, "integral"), ("NedelecSecondKind", 1, "integral(1)"),
    ("NedelecSecondKind", 1, "point"), ("NedelecSecondKind", 2, None),
    ("NedelecSecondKind", 2, "integral"), ("NedelecSecondKind", 2, "integral(1)"),
    ("NedelecSecondKind", 2, "point"), ("NedelecSecondKind", 3, None),
    ("NedelecSecondKind", 3, "integral"), ("NedelecSecondKind", 3, "integral(1)"),
    ("NedelecSecondKind", 3, "point"), ("DiscontinuousRaviartThomas", 1, None),
    ("DiscontinuousRaviartThomas", 2, None), ("DiscontinuousRaviartThomas", 3, None),
    ("Regge", 0, None), ("Regge", 1, None), ("Regge", 2, None), ("Regge", 1, "point"),
    ("HellanHerrmannJohnson", 0, None), ("HellanHerrmannJohnson", 1, None),
    ("HellanHerrmannJohnson", 2, None), ("HellanHerrmannJohnson", 1, "point"),
    ("GopalakrishnanLedererSchoberlFirstKind", 1, None),
    ("GopalakrishnanLedererSchoberlFirstKind", 2, None),
    ("GopalakrishnanLedererSchoberlFirstKind", 3, None),
    ("GopalakrishnanLedererSchoberlSecondKind", 0, None),
    ("GopalakrishnanLedererSchoberlSecondKind", 1, None),
    ("GopalakrishnanLedererSchoberlSecondKind", 2, None), ("BrezziDouglasFortinMarini", 2, None),
    ("BrezziDouglasFortinMarini", 3, None), ("BrezziDouglasFortinMarini", 2, "point"),
    ("GaussLegendre", 0, None), ("GaussLegendre", 1, None), ("GaussLegendre", 2, None),
    ("GaussLobattoLegendre", 1, None), ("GaussLobattoLegendre", 2, None),
    ("GaussLobattoLegendre", 3, None), ("Bubble", 3, None), ("Bubble", 3, "integral"),
    ("FacetBubble", 2, None), ("FacetBubble", 2, "integral"), ("KongMulderVeldhuizen", 1, None),
    ("KongMulderVeldhuizen", 2, None), ("KongMulderVeldhuizen", 3, None),
    ("KongMulderVeldhuizen", 4, None), ("KongMulderVeldhuizen", 5, None),
    ("KongMulderVeldhuizen", 6, None),
)
COMPOSITES_TRI = ("RestrictedElement-vertex", "RestrictedElement-facet", "NodalEnriched-T",
                  "NodalEnriched-RT")
FAMILIES_TET = (
    ("DiscontinuousTaylor", 0, None), ("DiscontinuousTaylor", 1, None),
    ("DiscontinuousTaylor", 2, None), ("CrouzeixRaviart", 1, None),
    ("CrouzeixRaviart", 1, "point"), ("NedelecSecondKind", 1, None),
    ("NedelecSecondKind", 1, "integral"), ("NedelecSecondKind", 1, "integral(1)"),
    ("NedelecSecondKind", 1, "point"), ("NedelecSecondKind", 2, None),
    ("NedelecSecondKind", 2, "integral"), ("NedelecSecondKind", 2, "integral(1)"),
    ("NedelecSecondKind", 2, "point"), ("NedelecSecondKind", 3, None),
    ("NedelecSecondKind", 3, "integral"), ("NedelecSecondKind", 3, "integral(1)"),
    ("NedelecSecondKind", 3, "point"), ("DiscontinuousRaviartThomas", 1, None),
    ("DiscontinuousRaviartThomas", 2, None), ("DiscontinuousRaviartThomas", 3, None),
    ("Regge", 0, None), ("Regge", 1, None), ("Regge", 2, None), ("Regge", 1, "point"),
    ("HellanHerrmannJohnson", 0, None), ("HellanHerrmannJohnson", 1, None),
    ("HellanHerrmannJohnson", 2, None), ("HellanHerrmannJohnson", 1, "point"),
    ("GopalakrishnanLedererSchoberlFirstKind", 1, None),
    ("GopalakrishnanLedererSchoberlFirstKind", 2, None),
    ("GopalakrishnanLedererSchoberlFirstKind", 3, None),
    ("GopalakrishnanLedererSchoberlSecondKind", 0, None),
    ("GopalakrishnanLedererSchoberlSecondKind", 1, None),
    ("GopalakrishnanLedererSchoberlSecondKind", 2, None), ("BrezziDouglasFortinMarini", 2, None),
    ("GaussLegendre", 0, None), ("GaussLegendre", 1, None), ("GaussLegendre", 2, None),
    ("GaussLobattoLegendre", 1, None), ("GaussLobattoLegendre", 2, None),
    ("GaussLobattoLegendre", 3, None), ("Bubble", 4, None), ("Bubble", 4, "integral"),
    ("FacetBubble", 3, None), ("FacetBubble", 3, "integral"),
)
COMPOSITES_TET = ("NodalEnriched-S", "NodalEnriched-Regge")
HEX_DEGREE = 8           # bench.py:522, the GLL element of hex_gll_sumfact
HEX_M = 46               # bench.py:523, Gauss-Jacobi points a direction
HEX_RTOL = 1e-12         # sum-factorised vs dense hexahedral moments, / max |dense|


def composite(name, T):
    """The COMPOSITES entry ``name`` of fiat_tpu's nodality sweep
    (tests/test_nodality_sweep.py:147-169), built on T by the port."""
    import fiat_tpu_torch as ft
    build = {
        "RestrictedElement-vertex": lambda: ft.RestrictedElement(
            ft.Lagrange(T, 2), restriction_domain="vertex"),
        "RestrictedElement-facet": lambda: ft.RestrictedElement(
            ft.Lagrange(T, 3), restriction_domain="facet"),
        "NodalEnriched-T": lambda: ft.NodalEnrichedElement(ft.Lagrange(T, 1), ft.Bubble(T, 3)),
        "NodalEnriched-S": lambda: ft.NodalEnrichedElement(ft.Lagrange(T, 1), ft.Bubble(T, 4)),
        "NodalEnriched-RT": lambda: ft.NodalEnrichedElement(
            ft.RaviartThomas(T, 1),
            ft.RestrictedElement(ft.RaviartThomas(T, 2), restriction_domain="interior")),
        "NodalEnriched-Regge": lambda: ft.NodalEnrichedElement(
            ft.Regge(T, 1), ft.RestrictedElement(ft.Regge(T, 2), restriction_domain="interior")),
        "NodalEnriched-GN": lambda: ft.NodalEnrichedElement(
            ft.GuzmanNeilanFirstKindH1(T, 0), ft.AlfeldSorokina(T)),
    }
    return build[name]()


def families_zoo(specs, composites, T):
    """The port's elements of a (family, degree, variant) list (degree None:
    a family that takes none), then the named composites."""
    import fiat_tpu_torch as ft
    return ([getattr(ft, fam)(T, *(() if deg is None else (deg,)),
                              **({} if v is None else {"variant": v}))
             for fam, deg, v in specs]
            + [composite(name, T) for name in composites])


def f64_cell(name, zoo, pts, P, card, torch, np, k3_beside=True):
    """A zoo on the f64 engine at ``pts`` (``P`` on the card):
    ``device_tabulator(zoo, order=1)`` on the default device runs K1 and K2,
    and for macro elements K3 (a triangle parent, at most 32 subcells in
    all) or K7; each kernel against its plain version, one launch of each a
    pass, the tables held to host (``host_bars``), and the pass, the kernels
    and their plain versions timed.  Where K7 runs, K3 built on the same
    merged programs is held to K7 and timed beside it (unless not
    ``k3_beside``).  Returns the engine and the kernels-line entries."""
    from fiat_tpu_torch import device_tabulator
    from fiat_tpu_torch.ops.fused_zoo import _merge_macro_programs
    from fiat_tpu_torch.ops.macro_oneshot import MacroOneShot, one_shot_applies

    t0 = time.perf_counter()
    tab = device_tabulator(zoo, order=1)           # the default device: the card
    rec, mm, k7 = tab.recurrence, tab.matmul, merged_macro(tab)
    if k7 is not None and k7.name == "K3":       # the engine's K3: run as the macro kernel
        return f64_k3_cell(name, zoo, tab, pts, P, card, torch, np, t0)
    merged = None if k7 is None else _merge_macro_programs(tab._programs, rec.scale,
                                                           (rec.A, rec.b), 1)
    if tab.features is not None or tab.device != P.device or (
            k7 is not None and (k7.name != "K7" or one_shot_applies(merged))):
        fail(f"{name}: K1 and K2, and K7 for macro elements past K3's routing, on {P.device}")
    gbytes = (mm.total_rows + (0 if k7 is None else k7.rows)) * NPTS * 8 / 1e9
    macro = "" if k7 is None else (
        f", K7 {k7.rows} x {k7.K} over {len(k7.nexp)} subcells in {len(k7.geom)} programs "
        f"({k7.chunks.shape[0]} row chunks, widest piece {k7.max_nexp}, {k7.words} mask words)")
    print(f"{name} host construction: {len(zoo)} elements, {tab.rows} rows x "
          f"{len(tab.alphas)} alphas, widths {tab.widths} (rows {mm.rows}), K2 plan {mm.plan}, "
          f"K1 sd {rec.sd} degree {rec.degree}{macro}; a pass writes {gbytes:.3f} GB; "
          f"{time.perf_counter() - t0:.2f} s")
    if k7 is not None:
        k7_plan_line(name, k7)
    phi_p = rec.plain(P)
    k1_abs = check_kernel(f"{name} K1 recurrence (sd {rec.sd}, degree {rec.degree}) at {NPTS} "
                          f"points", rec(P), phi_p, torch)
    C_k = mm(phi_p)
    C_p = mm.plain(phi_p)
    k2_abs = check_kernel(f"{name} K2 bucket matmul ({mm.total_rows} x {NPTS}, widths {mm.K})",
                          C_k, C_p, torch)
    worst = max(rel_err(a, b)[1] for a, b in zip(mm.views(C_k), mm.views(C_p)))
    if not worst <= KERNEL_RTOL:
        fail(f"{name} K2 disagrees with its plain version on a group: rel {worst:.3e}")
    del C_k, C_p
    engines = {"K1": rec, "K2": mm}
    if k7 is not None:
        engines["K7"] = k7
        k7_scales = row_scales(k7.A, k7.masked_basis(k7.masks(P)[0], phi_p))
        k7_abs = check_scaled(f"{name} K7 masked matmul ({k7.rows} x {NPTS})", k7(P, phi_p),
                              k7.plain(P, phi_p), k7_scales)
    del phi_p
    blocks, launches = counted(engines, lambda: tab.block_tables(P), torch)
    expect_launches(f"{name} f64", launches, dict.fromkeys(engines, 1))
    if not all(bool(torch.isfinite(b).all()) for bl in blocks.values() for b in bl):
        fail(f"{name}: non-finite values in the tables")
    host_err = host_bars(name, zoo, tab.unpack(blocks), pts, NPTS, np)
    del blocks
    torch.cuda.empty_cache()

    phi = rec(P)
    k1_ms, k1_plain = median_ms(lambda: rec(P), torch), plain_ms(lambda: rec.plain(P), torch)
    k2_ms, k2_plain = median_ms(lambda: mm(phi), torch), plain_ms(lambda: mm.plain(phi), torch)
    A = mm.A.to(phi.device)
    k2_lib = median_ms(lambda: torch.matmul(A, phi[:mm.max_k]), torch)  # one padded DGEMM
    k1_card, k2_card = queued_ms(lambda: rec(P), torch), queued_ms(lambda: mm(phi), torch)
    del A
    k1_bound, k2_bound = rec_bound(rec, NPTS), matmul_bound(mm, NPTS)
    macro = ""
    if k7 is not None:
        k7_ms, k7_plain = median_ms(lambda: k7(P, phi), torch), plain_ms(lambda: k7.plain(P, phi),
                                                                          torch)
        B, A7 = k7.masked_basis(k7.masks(P)[0], phi), k7.A.to(P.device)
        k7_lib = median_ms(lambda: torch.matmul(A7, B), torch)     # one DGEMM, B given
        del B, A7
        k7_card = queued_ms(lambda: k7(P, phi), torch)
        k7_bound = masked_bound(k7, NPTS)
        macro = (f", K7 {k7_ms:.4f} ms (card {k7_card:.4f}, plain {k7_plain:.4f}, one DGEMM on "
                 f"the masked B {k7_lib:.4f}, bound {k7_bound[0]:.4f} by {k7_bound[1]}; "
                 f"{k7_bound[0] / k7_card:.0%} of its bound)")
    if k7 is not None and k3_beside:
        # K3 as the engine would build it on these programs, beside K7
        k3 = MacroOneShot(**merged, device=P.device)
        print(f"{name}: K3 on the f64 engine's merged programs: {k3.rows} x {k3.K}, parent "
              f"degree {k3.degree}, {k3.chunks.shape[0]} row chunks, plan {k3.plan}, "
              f"{k3.smem} bytes of shared memory a block")
        check_scaled(f"{name} K3 on the merged programs, against K7 (not its plain version),",
                     k3(P), k7(P, phi), k7_scales)
        k3_ms, k3_card = median_ms(lambda: k3(P), torch), queued_ms(lambda: k3(P), torch)
        k3_plain, k3_lib = plain_ms(lambda: k3.plain(P), torch), masked_gemm_ms(k3, P, torch)
        k3_bound = macro_bound(k3, NPTS)
        del k3
        macro += (f"; K3 on the same programs {k3_ms:.4f} ms (card {k3_card:.4f}, plain "
                  f"{k3_plain:.4f}, one DGEMM on the masked B {k3_lib:.4f}, bound "
                  f"{k3_bound[0]:.4f} by {k3_bound[1]}): K7 / K3 card {k7_card / k3_card:.3f}")
    del phi
    path_ms = median_ms(lambda: tab.block_tables(P), torch)

    def plain_path():
        phi = rec.plain(P)
        return mm.plain(phi), None if k7 is None else k7.plain(P, phi)

    plain_path_ms = plain_ms(plain_path, torch)
    print(f"{name} timing ({card}; median of {REPS} runs of {INNER}, CUDA events; card: the "
          f"same with the calls queued behind a spin): pass {path_ms:.4f} ms "
          f"({gbytes / path_ms:.3f} TB/s; the store of its tables alone "
          f"{gbytes * 1e9 / HBM_BYTES_MS:.4f} ms), plain path {plain_path_ms:.4f} ms; K1 "
          f"{k1_ms:.4f} ms (card {k1_card:.4f} ms, plain {k1_plain:.4f}, bound "
          f"{k1_bound[0]:.4f} by {k1_bound[1]}), K2 {k2_ms:.4f} ms = {k2_rates(mm, k2_ms)} "
          f"(card {k2_card:.4f} ms, plain {k2_plain:.4f}, one padded DGEMM {k2_lib:.4f}, bound "
          f"{k2_bound[0]:.4f} by {k2_bound[1]}){macro}; host error {host_err:.3e}")
    src = "fiat_tpu_torch/csrc/"
    entries = [
        entry(f"K1 dubiner{rec.sd}_values{generic(rec)} ({name})", src + "recurrence.cu",
              "fiat_tpu/ops/pallas_recurrence.py:399", launches["K1"], k1_abs, k1_ms, k1_plain,
              k1_bound),
        entry(f"K2 bucket_matmul{wide(mm)} ({name})", src + "bucket_matmul.cu",
              "fiat_tpu/ops/pallas_multiword.py:269", launches["K2"], k2_abs, k2_ms, k2_plain,
              k2_bound, k2_lib)]
    if k7 is not None:
        entries.append(entry(f"K7 masked_matmul ({name})", src + "masked_matmul.cu",
                             "fiat_tpu/ops/pallas_multiword.py:440", launches["K7"], k7_abs,
                             k7_ms, k7_plain, k7_bound, k7_lib))
    return tab, entries


def f64_k3_cell(name, zoo, tab, pts, P, card, torch, np, t0):
    """``f64_cell`` for a zoo whose macro programs the f64 engine gives K3
    (a triangle parent, at most 32 subcells in all): K1, K2 and K3, each
    against its plain version (K3 row by row to its own max |A_r| |B|), one
    launch each a pass, the tables to host, and the pass, the kernels, their
    plain versions and one DGEMM on K3's masked B timed."""
    rec, mm, k3 = tab.recurrence, tab.matmul, merged_macro(tab)
    if tab.features is not None or tab.device != P.device:
        fail(f"{name}: K1, K2 and K3 on {P.device}")
    gbytes = (mm.total_rows + k3.rows) * NPTS * 8 / 1e9
    print(f"{name} host construction: {len(zoo)} elements, {tab.rows} rows x "
          f"{len(tab.alphas)} alphas, widths {tab.widths} (rows {mm.rows}), K2 plan {mm.plan}, "
          f"K1 sd {rec.sd} degree {rec.degree}, K3 {k3.rows} x {k3.K} over {len(k3.nexp)} "
          f"subcells in {len(k3.geom)} programs ({k3.chunks.shape[0]} row chunks, plan "
          f"{k3.plan}, {k3.smem} bytes of shared memory a block); a pass writes {gbytes:.3f} GB; "
          f"{time.perf_counter() - t0:.2f} s")
    phi_p = rec.plain(P)
    k1_abs = check_kernel(f"{name} K1 recurrence (sd {rec.sd}, degree {rec.degree}) at {NPTS} "
                          f"points", rec(P), phi_p, torch)
    C_k, C_p = mm(phi_p), mm.plain(phi_p)
    k2_abs = check_kernel(f"{name} K2 bucket matmul ({mm.total_rows} x {NPTS}, widths {mm.K})",
                          C_k, C_p, torch)
    del C_k, C_p, phi_p
    k3_abs = check_scaled(f"{name} K3 ({k3.rows} x {NPTS}, plan {k3.plan})", k3(P), k3.plain(P),
                          oneshot_scale(k3, P))
    engines = {"K1": rec, "K2": mm, "K3": k3}
    blocks, launches = counted(engines, lambda: tab.block_tables(P), torch)
    expect_launches(f"{name} f64", launches, dict.fromkeys(engines, 1))
    if not all(bool(torch.isfinite(b).all()) for bl in blocks.values() for b in bl):
        fail(f"{name}: non-finite values in the tables")
    host_err = host_bars(name, zoo, tab.unpack(blocks), pts, NPTS, np)
    del blocks
    torch.cuda.empty_cache()
    phi = rec(P)
    k1_ms, k1_plain = median_ms(lambda: rec(P), torch), plain_ms(lambda: rec.plain(P), torch)
    k2_ms, k2_plain = median_ms(lambda: mm(phi), torch), plain_ms(lambda: mm.plain(phi), torch)
    A = mm.A.to(phi.device)
    k2_lib = median_ms(lambda: torch.matmul(A, phi[:mm.max_k]), torch)  # one padded DGEMM
    del A, phi
    k3_ms, k3_card = median_ms(lambda: k3(P), torch), queued_ms(lambda: k3(P), torch)
    k3_plain, k3_lib = plain_ms(lambda: k3.plain(P), torch), masked_gemm_ms(k3, P, torch)
    k1_bound, k2_bound, k3_bound = rec_bound(rec, NPTS), matmul_bound(mm, NPTS), macro_bound(
        k3, NPTS)
    path_ms = median_ms(lambda: tab.block_tables(P), torch)

    def plain_path():
        phi = rec.plain(P)
        return mm.plain(phi), k3.plain(P)

    plain_path_ms = plain_ms(plain_path, torch)
    print(f"{name} timing ({card}; median of {REPS} runs of {INNER}, CUDA events; card: the "
          f"same with the calls queued behind a spin): pass {path_ms:.4f} ms "
          f"({gbytes / path_ms:.3f} TB/s; the store of its tables alone "
          f"{gbytes * 1e9 / HBM_BYTES_MS:.4f} ms), plain path {plain_path_ms:.4f} ms; K1 "
          f"{k1_ms:.4f} ms (plain {k1_plain:.4f}, bound {k1_bound[0]:.4f} by {k1_bound[1]}), K2 "
          f"{k2_ms:.4f} ms (plain {k2_plain:.4f}, one padded DGEMM {k2_lib:.4f}, bound "
          f"{k2_bound[0]:.4f} by {k2_bound[1]}), K3 {k3_ms:.4f} ms (card {k3_card:.4f}, plain "
          f"{k3_plain:.4f}, one DGEMM on the masked B {k3_lib:.4f}, bound {k3_bound[0]:.4f} by "
          f"{k3_bound[1]}; {k3_bound[0] / k3_card:.0%} of its bound); host error {host_err:.3e}")
    src = "fiat_tpu_torch/csrc/"
    return tab, [
        entry(f"K1 dubiner{rec.sd}_values{generic(rec)} ({name})", src + "recurrence.cu",
              "fiat_tpu/ops/pallas_recurrence.py:399", launches["K1"], k1_abs, k1_ms, k1_plain,
              k1_bound),
        entry(f"K2 bucket_matmul{wide(mm)} ({name})", src + "bucket_matmul.cu",
              "fiat_tpu/ops/pallas_multiword.py:269", launches["K2"], k2_abs, k2_ms, k2_plain,
              k2_bound, k2_lib),
        entry(f"K3 macro_oneshot sd {k3.sd}{generic(k3)} ({name})", src + "macro_oneshot.cu",
              "fiat_tpu/ops/pallas_multiword.py:652", launches["K3"], k3_abs, k3_ms, k3_plain,
              k3_bound, k3_lib)]


def k2_by_group(name, mm, P, phi, torch):
    """K2 on each width group of ``mm`` alone (a BucketMatmul of that
    group's rows; device time, its calls queued behind a spin), against
    the group's own bound: which contraction width costs the most against
    its bytes."""
    from fiat_tpu_torch.ops.fused_zoo import BucketMatmul
    A = mm.A.cpu().numpy()
    for off, K, rows in zip(mm.offsets, mm.K, mm.rows):
        one = BucketMatmul([A[off:off + rows, :K]], device=P.device)
        ms = queued_ms(lambda: one(phi), torch)
        bound = matmul_bound(one, NPTS)
        print(f"{name} K2 width {K} alone ({rows} rows x {NPTS}, plan {one.plan}): {ms:.4f} ms, "
              f"bound {bound[0]:.4f} by {bound[1]} ({bound[0] / ms:.0%} of it), "
              f"{rows * NPTS * 8 / 1e9 / ms:.3f} TB/s of C")


def dual_cell(name, zoo, pts, P, card, torch, np):
    """``moment_rows`` (K45 alone, one launch) and ``interpolate_rows`` (K1,
    and K3 one row per program where the zoo has macro elements; one
    launch each) on a ``BatchedTabulator(zoo, order=0)`` on the default
    device, held to host (``host_dual_check``); K45 and K3 against their
    plain versions and timed.  Returns their kernels-line entries."""
    from fiat_tpu_torch.ops import moments as mo
    from fiat_tpu_torch.ops.tabulate import BatchedTabulator

    t0 = time.perf_counter()
    bt = BatchedTabulator(zoo, order=0)            # the default device: the card
    eng = mo.moment_engine(bt)
    pm, rec, m3 = eng.moments, eng.recurrence, merged_macro(eng)
    if m3 is not None and m3.name != "K3":
        fail(f"{name}: interpolation runs K3 for the macro elements")
    masked = "" if m3 is None else (
        f": {pm.nplain} plain + {pm.rows - pm.nplain} masked over {len(pm.piece_nexp)} subcells "
        f"in {len(pm.geom)} programs; K3 one row per program over {len(m3.nexp)} subcells")
    print(f"{name} dual host construction: {len(zoo)} elements, {eng.rows} rows, K45 {pm.rows} "
          f"sums (sd {pm.sd}, degree {pm.degree}{masked}; {pm.warps} warps a block, {pm.smem} "
          f"bytes of shared memory), {time.perf_counter() - t0:.2f} s")
    wf_h = np.random.default_rng(7).random(NPTS)      # bench.py:441
    wf = torch.as_tensor(wf_h, device=P.device)
    c_h = np.random.default_rng(11).random(eng.rows) - 0.5
    c = torch.as_tensor(c_h, device=P.device)
    k45_abs = check_kernel(f"{name} K45 ({pm.rows} sums over {NPTS} points)", pm(P, wf),
                           pm.plain(P, wf), torch)
    check_k45_alone(name, pm, P, wf, torch)
    engines = {"K45": pm, "K1": rec}
    if m3 is not None:
        engines["K3"] = m3
        W = eng.program_columns[0] * (c @ eng.matrix)[eng.nexp:]
        w_abs = check_scaled(f"{name} K3 one row per program ({W.shape[0]} x {W.shape[1]})",
                             m3(P, A=W), m3.plain(P, A=W), oneshot_scale(m3, P, W))
    M, launches = counted(engines, lambda: mo.moment_rows(bt, P, wf), torch)
    expect_launches(f"{name} moments", launches, {**dict.fromkeys(engines, 0), "K45": 1})
    k45_launches = launches["K45"]
    u, launches = counted(engines, lambda: mo.interpolate_rows(bt, P, c), torch)
    expect_launches(f"{name} interpolation", launches, {**dict.fromkeys(engines, 1), "K45": 0})
    if tuple(M.shape) != (eng.rows,) or tuple(u.shape) != (NPTS,):
        fail(f"{name}: moments {tuple(M.shape)} / interpolation {tuple(u.shape)}: wrong shapes")
    if not (bool(torch.isfinite(M).all()) and bool(torch.isfinite(u).all())):
        fail(f"{name}: non-finite moments or interpolated values")
    host_dual_check(name, zoo, bt, mo, P, pts, wf, wf_h, u, c_h, np)
    mom_ms = median_ms(lambda: mo.moment_rows(bt, P, wf), torch)
    int_ms = median_ms(lambda: mo.interpolate_rows(bt, P, c), torch)
    k45_ms, k45_plain = median_ms(lambda: pm(P, wf), torch), plain_ms(lambda: pm.plain(P, wf),
                                                                      torch)
    k45_lib = stack_mv_ms(pm, P, wf, torch)
    k45_card = queued_ms(lambda: pm(P, wf), torch)
    k45_bound = moments_bound(pm, NPTS)
    macro = ""
    if m3 is not None:
        w_ms, w_plain = median_ms(lambda: m3(P, A=W), torch), plain_ms(lambda: m3.plain(P, A=W),
                                                                      torch)
        w_card = queued_ms(lambda: m3(P, A=W), torch)
        B = m3.operand(P)[0]
        w_lib = median_ms(lambda: torch.matmul(W, B), torch)      # one DGEMM, B given
        del B
        w_bound = macro_bound(m3, NPTS, one_row=True)
        macro = (f"; K3 one row per program {w_ms:.4f} ms (card {w_card:.4f}, plain "
                 f"{w_plain:.4f}, one DGEMM on the masked B {w_lib:.4f}, bound {w_bound[0]:.4f} "
                 f"by {w_bound[1]})")
    print(f"{name} dual timing at {NPTS} points ({card}; median of {REPS} runs of {INNER}, CUDA "
          f"events; card: queued behind a spin): moment_rows {mom_ms:.4f} ms, interpolate_rows "
          f"{int_ms:.4f} ms; K45 {k45_ms:.4f} ms (card {k45_card:.4f} ms, plain {k45_plain:.4f}, "
          f"one DGEMV on its stack built beforehand {k45_lib:.4f}, bound {k45_bound[0]:.4f} by "
          f"{k45_bound[1]}){macro}")
    entries = [entry(f"K45 pair_moments sd {pm.sd}{generic(pm)} ({name})",
                     "fiat_tpu_torch/csrc/moments.cu",
                     "fiat_tpu/ops/pallas_recurrence.py:549, fiat_tpu/ops/pallas_recurrence.py:727",
                     k45_launches, k45_abs, k45_ms, k45_plain, k45_bound, k45_lib)]
    if m3 is not None:
        entries.append(entry(f"K3 macro_oneshot sd {m3.sd}{generic(m3)} ({name} interpolation, "
                             f"one row per program)", "fiat_tpu_torch/csrc/macro_oneshot.cu",
                             "fiat_tpu/ops/pallas_multiword.py:652", launches["K3"], w_abs, w_ms,
                             w_plain, w_bound, w_lib))
    return entries


def f32_cell(name, zoo, P, tab64, card, torch):
    """The f32 engine: ``device_tabulator(zoo, order=1, f64=False).tables``
    on the default device (K6, and K3 float32 for the macro elements; one
    launch each a pass), each kernel against its plain version, and the
    tables held to the f64 engine ``tab64``'s element by element, so that no
    second f64 copy of the tables is made: plain rows per alpha to F32_RTOL
    of the alpha's max abs; macro rows per element and alpha to
    F32_MACRO_TOL (or the element's own bar in F32_OWN_BARS) of max abs + 1,
    at the points the float32 binning puts in the same subcells as the
    float64 one (``same_subcells``).  Returns the kernels-line entries."""
    from fiat_tpu_torch import device_tabulator

    t0 = time.perf_counter()
    tab = device_tabulator(zoo, order=1, f64=False)   # the default device: the card
    k6, m3 = tab.kernel, merged_macro(tab)
    if tab.device != P.device or (m3 is not None and m3.name != "K3"):
        fail(f"{name} f32: K6, and K3 float32 for the macro elements, on {P.device}")
    macro = "" if m3 is None else (
        f", K3 float32 {m3.rows} x {m3.K} over {len(m3.nexp)} subcells (plan {m3.plan}, "
        f"{m3.smem} bytes of shared memory a block)")
    print(f"{name} f32 host construction: {tab.rows} rows x {len(tab.alphas)} alphas, K6 "
          f"{k6.total_rows} rows in widths {k6.K} (sd {k6.sd}, variant {k6.variant}){macro}, "
          f"{time.perf_counter() - t0:.2f} s")
    k6_plan_line(f"{name} f32", k6)
    P32 = P.float()
    out = torch.empty((k6.total_rows, NPTS), device=P.device)
    k6_abs = check_kernel(f"{name} K6 ({k6.total_rows} x {NPTS})",
                          k6(P32, tab.dst_plain, out).clone(),
                          k6.plain(P32, tab.dst_plain, out), torch, F32_KERNEL_RTOL)
    engines = {"K6": k6}
    if k6.mode == "wide":        # phase 30: K6's Phi stage is a launch of its own
        engines["K6 Phi stage"] = StageLaunches(k6)
        stage_abs = check_kernel(f"{name} K6 Phi stage ({k6.kpad} x {NPTS})",
                                 wide_phi(k6, P32, torch), k6.phi(P32)[:k6.max_k], torch,
                                 WIDE_PHI_RTOL)
    if m3 is not None:
        engines["K3 float32"] = m3
        m3_abs = check_scaled(f"{name} K3 float32 ({m3.rows} x {NPTS})", m3(P32), m3.plain(P32),
                              oneshot_scale(m3, P32), F32_KERNEL_RTOL)
    tables, launches = counted(engines, lambda: tab.tables(P), torch)
    expect_launches(f"{name} f32", launches, dict.fromkeys(engines, 1))
    if not all(bool(torch.isfinite(t).all()) for t in tables.values()):
        fail(f"{name} f32: non-finite values in the tables")
    per64 = tab64.unpack(tab64.block_tables(P))
    keep = slice(None)
    if m3 is not None:
        keep = m3.same_subcells(P)
        print(f"{name} f32: {int((~keep).sum())} of {NPTS} points lie within the float32 binning "
              f"tolerance of an interior face, where float32 averages over the subcells that "
              f"meet and float64 does not; macro rows compared on the other {int(keep.sum())}")
    err, scale = dict.fromkeys(tab.alphas, 0.0), dict.fromkeys(tab.alphas, 0.0)
    macro_worst, own, no_digits = 0.0, [], []
    for el, (lo, hi, _), t64 in zip(zoo, tab.slices, per64):
        for a in tab.alphas:
            ref = t64[a].reshape(hi - lo, NPTS)
            if lo < tab.plain_rows:
                err[a] = max(err[a], (tables[a][lo:hi].double() - ref).abs().max().item())
                scale[a] = max(scale[a], ref.abs().max().item())
                continue
            ref = ref[:, keep]
            rel = ((tables[a][lo:hi, keep].double() - ref).abs().max().item()
                   / (ref.abs().max().item() + 1.0))
            if split_label(el) in F32_NO_DIGITS:
                no_digits.append(f"{split_label(el)} {a} {rel:.3e}")
                continue
            bar = f32_own_bar(el)
            if bar is not None:
                own.append(f"{split_label(el)} {a} {rel:.3e}")
            else:
                bar = F32_MACRO_TOL
                macro_worst = max(macro_worst, rel)
            if not rel <= bar:
                fail(f"{name} f32 macro rows of {element_label(el)} {a}: {rel:.3e} of max abs "
                     f"+ 1 > {bar}")
    worst = max(err[a] / scale[a] for a in tab.alphas)
    rtol = (INTERVAL_F32_RTOL if on_interval(zoo[0]) else WIDE_F32_RTOL if wide(k6)
            else HIGH_DEGREE_F32_RTOL if any(map(high_degree, zoo)) else F32_RTOL)
    if not worst <= rtol:
        fail(f"{name} f32 plain rows: an alpha at {worst:.3e} of its max > {rtol}")
    print(f"{name} f32 vs the f64 tables on all {NPTS} points: plain rows, worst alpha "
          f"{worst:.3e} of its max abs (limit {rtol})" + ("" if m3 is None else (
              f"; macro rows {macro_worst:.3e} of max abs + 1 (limit {F32_MACRO_TOL})"
              + (f", on their own bars ({json.dumps({**F32_OWN_BARS, **INTERVAL_F32_BARS})}): "
                 f"{', '.join(own)}"
                 if own else "")
              + (f"; not held (F32_NO_DIGITS, ill-conditioned in float32; K3 float32 held to "
                 f"its plain version above): {', '.join(no_digits)}" if no_digits else ""))))
    del tables, per64
    torch.cuda.empty_cache()
    k6_ms = median_ms(lambda: k6(P32, tab.dst_plain, out), torch)
    k6_plain = plain_ms(lambda: k6.plain(P32, tab.dst_plain, out), torch)
    k6_lib = zoo_f32_library_ms(k6, P32, torch)
    k6_card = queued_ms(lambda: k6(P32, tab.dst_plain, out), torch)
    del out
    k6_bound = zoo_f32_bound(k6, NPTS)
    macro = ""
    if m3 is not None:
        m3_ms, m3_plain = median_ms(lambda: m3(P32), torch), plain_ms(lambda: m3.plain(P32),
                                                                      torch)
        m3_lib = masked_gemm_ms(m3, P32, torch)
        m3_card = queued_ms(lambda: m3(P32), torch)
        m3_bound = macro_bound(m3, NPTS, 4, FP32_FMA_MS)
        macro = (f"; K3 float32 {m3_ms:.4f} ms (card {m3_card:.4f}, plain {m3_plain:.4f}, one "
                 f"SGEMM on the masked B {m3_lib:.4f}, bound {m3_bound[0]:.4f} by {m3_bound[1]})")
    path_ms = median_ms(lambda: tab.tables(P), torch)
    gbytes = len(tab.alphas) * tab.rows * NPTS * 4 / 1e9
    print(f"{name} f32 timing ({card}; median of {REPS} runs of {INNER}, CUDA events; card: "
          f"queued behind a spin): tables {path_ms:.4f} ms ({gbytes:.3f} GB = "
          f"{gbytes / path_ms:.3f} TB/s); K6 {k6_ms:.4f} ms (card {k6_card:.4f} ms, plain "
          f"{k6_plain:.4f}, one padded SGEMM on a computed Phi {k6_lib:.4f}, bound "
          f"{k6_bound[0]:.4f} by {k6_bound[1]}){macro}")
    src = "fiat_tpu_torch/csrc/zoo_f32" + ("_wide.cu" if wide(k6) else ".cu")
    entries = [entry(f"K6 zoo_f32 sd {k6.sd}{generic(k6)}{wide(k6)} ({name})", src,
                     "fiat_tpu/ops/pallas_tabulate.py:248", launches["K6"], k6_abs, k6_ms,
                     k6_plain, k6_bound, k6_lib)]
    if wide(k6):
        stage_ms = median_ms(lambda: k6.phi_stage(P32), torch)
        stage_plain = plain_ms(lambda: k6.phi(P32), torch)
        stage_card = queued_ms(lambda: k6.phi_stage(P32), torch)
        stage_bound = bound_of(4 * NPTS * (k6.sd + k6.kpad), rec_flops(k6.sd, k6.degree) * NPTS,
                               FP32_FMA_MS)
        print(f"{name} f32 K6 Phi stage ({k6.kpad} x {NPTS}): {stage_ms:.4f} ms (card "
              f"{stage_card:.4f}, plain {stage_plain:.4f}, bound {stage_bound[0]:.4f} by "
              f"{stage_bound[1]}; {card})")
        entries.append(entry(f"K6 Phi stage sd {k6.sd}{generic(k6)} ({name})", src,
                             "fiat_tpu/ops/pallas_tabulate.py:248", launches["K6 Phi stage"],
                             stage_abs, stage_ms, stage_plain, stage_bound))
    if m3 is not None:
        entries.append(entry(f"K3 macro_oneshot float32 sd {m3.sd}{generic(m3)} ({name})",
                             "fiat_tpu_torch/csrc/macro_oneshot.cu",
                             "fiat_tpu/ops/pallas_multiword.py:652", launches["K3 float32"],
                             m3_abs, m3_ms, m3_plain, m3_bound, m3_lib))
    return entries


class StageLaunches:
    """The launch count of K6's Phi stage in its wide mode, as ``counted``
    reads and resets a wrapper's ``launches``."""

    def __init__(self, k6):
        self.k6 = k6

    @property
    def launches(self):
        return self.k6.phi_launches

    @launches.setter
    def launches(self, n):
        self.k6.phi_launches = n


def wide_phi(k6, P32, torch):
    """K6's wide Phi stage at ``P32``, its rows of Phi with each point's
    column in place (the stage keeps point p in column p ^ 1)."""
    cols = torch.arange(P32.shape[0], device=P32.device) ^ 1
    return k6.phi_stage(P32)[:k6.max_k, cols]


def zoo_phase(cells, dev, card, torch, np, k3_beside=True):
    """Each (sd, name, make) of ``cells``, a zoo built by make() at pts2
    (sd = 2) or pts3 (sd = 3), through every entry point: f64 tables (K1 +
    K2, and K7 for macro elements past 32 subcells), moments (K45),
    interpolation (K1, and K3 one row per program) and f32 tables (K6, and
    K3 float32), one launch of each kernel a pass; K2 timed by width group.
    Phases 10-11 (the nodal families), 14-15 (the Stokes, elasticity and
    C2 families) and 16-17 (the split variants); ``k3_beside`` as
    ``f64_cell`` takes it."""
    kernels = []
    for sd, name, make in cells:
        torch.cuda.empty_cache()
        pts = make_points(NPTS, SEED, np, sd=sd)
        P = torch.as_tensor(pts, device=dev)
        t0 = time.perf_counter()
        zoo = make()
        print(f"{name}: {len(zoo)} elements built on the host in "
              f"{time.perf_counter() - t0:.2f} s")
        tab64, f64_entries = f64_cell(name, zoo, pts, P, card, torch, np, k3_beside)
        torch.cuda.empty_cache()
        k2_by_group(name, tab64.matmul, P, tab64.recurrence(P), torch)
        kernels += f64_entries
        kernels += dual_cell(name, zoo, pts, P, card, torch, np)
        kernels += f32_cell(name, zoo, P, tab64, card, torch)
        del tab64, P
        torch.cuda.empty_cache()
    return kernels


def interval_phase(dev, card, torch, np):
    """Phase 20, ``interval_zoo``: INTERVAL_ZOO at 1e5 points of the
    interval through every entry point (``zoo_phase``: f64 tables on K1 +
    K2 + K3, moments on K45, interpolation on K1 + K3 one row per program,
    f32 tables on K6 + K3 float32), then INTERVAL_BERNSTEIN on the Bernstein
    route (``bernstein_cell``: K8 + K2)."""
    from fiat_tpu_torch import ufc_simplex

    I = ufc_simplex(1)
    kernels = zoo_phase([(1, "interval_zoo", lambda: families_zoo(INTERVAL_ZOO, (), I))],
                        dev, card, torch, np)
    pts = make_points(NPTS, SEED, np, sd=1)
    P = torch.as_tensor(pts, device=dev)
    kernels += bernstein_cell("interval_bernstein", families_zoo(INTERVAL_BERNSTEIN, (), I),
                              pts, P, card, torch, np)
    return kernels


def bernstein_cell(name, zoo, pts, P, card, torch, np, route_bar=None):
    """A zoo of one contraction width on the Bernstein route:
    ``FusedZooTabulator(..., features="bernstein").block_tables`` on the
    default device (K8, then K2 on its features with the conversion folded
    into K2's rows), each kernel against its plain version, one launch of
    each a pass, the tables held to host (``host_bars``; with ``route_bar``,
    where the conversion's growth amplifies rounding past the host bar, to
    the zoo's Dubiner-route tables at that bar of max(1, max |table|) per
    alpha, the distance from host printed), and the pass, the kernels and
    their plain versions timed.  Returns the kernels-line entries."""
    from fiat_tpu_torch.ops.fused_zoo import FusedZooTabulator
    from fiat_tpu_torch.ops.tabulate import BatchedTabulator

    t0 = time.perf_counter()
    tab = FusedZooTabulator(BatchedTabulator(zoo, order=1, device="cpu"), features="bernstein")
    feat, mm = tab.features, tab.matmul
    if tab.recurrence is not None or tab.device != P.device:
        fail(f"{name}: K8 and K2 on {P.device}")
    print(f"{name} host construction: {len(zoo)} elements, {tab.rows} rows x "
          f"{len(tab.alphas)} alphas, K {mm.max_k}, K8 sd {feat.sd} degree {feat.degree}; "
          f"{time.perf_counter() - t0:.2f} s")
    b_p = feat.plain(P)
    k8_abs = check_kernel(f"{name} K8 Bernstein features (sd {feat.sd}, degree {feat.degree}) "
                          f"at {NPTS} points", feat(P), b_p, torch)
    k2_abs = check_kernel(f"{name} K2 bucket matmul ({mm.total_rows} x {NPTS}, K {mm.max_k})",
                          mm(b_p), mm.plain(b_p), torch)
    del b_p
    engines = {"K8": feat, "K2": mm}
    blocks, launches = counted(engines, lambda: tab.block_tables(P), torch)
    expect_launches(name, launches, dict.fromkeys(engines, 1))
    if not all(bool(torch.isfinite(b).all()) for bl in blocks.values() for b in bl):
        fail(f"{name}: non-finite values in the tables")
    if route_bar is None:
        host_bars(name, zoo, tab.unpack(blocks), pts, NPTS, np)
    else:
        bernstein_route_check(name, zoo, tab, blocks, pts, P, route_bar, torch, np)
    del blocks
    feats = feat(P)
    k8_ms, k8_plain = median_ms(lambda: feat(P), torch), plain_ms(lambda: feat.plain(P), torch)
    k8_card = queued_ms(lambda: feat(P), torch)
    k2_ms, k2_plain = median_ms(lambda: mm(feats), torch), plain_ms(lambda: mm.plain(feats),
                                                                    torch)
    A = mm.A.to(P.device)
    k2_lib = median_ms(lambda: torch.matmul(A, feats), torch)      # one cuBLAS DGEMM
    k2_card = queued_ms(lambda: mm(feats), torch)
    del A, feats
    path_ms = median_ms(lambda: tab.block_tables(P), torch)
    plain_path_ms = plain_ms(lambda: mm.plain(feat.plain(P)), torch)
    k8_bound, k2_bound = features_bound(feat, NPTS), matmul_bound(mm, NPTS)
    print(f"{name} timing ({card}; median of {REPS} runs of {INNER}, CUDA events; card: the "
          f"same with the calls queued behind a spin): pass {path_ms:.4f} ms, plain path "
          f"{plain_path_ms:.4f} ms; K8 {k8_ms:.4f} ms (card {k8_card:.4f}, plain {k8_plain:.4f}, "
          f"bound {k8_bound[0]:.4f} by {k8_bound[1]}), K2 {k2_ms:.4f} ms = {k2_rates(mm, k2_ms)} "
          f"(card {k2_card:.4f}, plain {k2_plain:.4f}, one DGEMM {k2_lib:.4f}, bound "
          f"{k2_bound[0]:.4f} by {k2_bound[1]})")
    src = "fiat_tpu_torch/csrc/"
    return [entry(f"K8 bernstein_features{generic(feat)} ({name})", src + "bernstein.cu",
                  "fiat_tpu/ops/pallas_bernstein.py:288", launches["K8"], k8_abs, k8_ms,
                  k8_plain, k8_bound),
            entry(f"K2 bucket_matmul{wide(mm)} ({name}, K {mm.max_k})", src + "bucket_matmul.cu",
                  "fiat_tpu/ops/pallas_multiword.py:269", launches["K2"], k2_abs, k2_ms,
                  k2_plain, k2_bound, k2_lib)]


def bernstein_route_check(name, zoo, tab, blocks, pts, P, bar, torch, np):
    """The Bernstein route's tables ``blocks`` against the Dubiner route's
    (``FusedZooTabulator`` on the same zoo, K1 + K2) on all the points, at
    ``bar`` of max(1, max |table|) per alpha; their distance from host on
    the first HOST_CHECK_PTS points printed (the conversion M's growth
    amplifies rounding: ROADMAP section 3)."""
    from fiat_tpu_torch.ops.fused_zoo import FusedZooTabulator
    from fiat_tpu_torch.ops.tabulate import BatchedTabulator

    dub = FusedZooTabulator(BatchedTabulator(zoo, order=1, device="cpu"))
    got, want = tab.unpack(blocks), dub.unpack(dub.block_tables(P))
    to_dub, to_host = 0.0, 0.0
    for el, g, w in zip(zoo, got, want):
        host = el.tabulate(1, pts[:HOST_CHECK_PTS])
        for a in host:
            big = max(1.0, w[a].abs().max().item())
            to_dub = max(to_dub, (g[a] - w[a]).abs().max().item() / big)
            err = float(np.abs(g[a][..., :HOST_CHECK_PTS].cpu().numpy() - host[a]).max())
            to_host = max(to_host, err / max(1.0, np.abs(host[a]).max()))
    print(f"{name} main path vs the Dubiner route's tables on {NPTS} points: {to_dub:.3e} of "
          f"max(1, max |table|) per alpha (bar {bar}); vs host el.tabulate on "
          f"{HOST_CHECK_PTS} points {to_host:.3e} (not held: the conversion's growth)")
    if not to_dub <= bar:
        fail(f"{name}: the Bernstein route is {to_dub:.3e} from the Dubiner route's tables > "
             f"{bar}")


def bench_tri_phase(T, dev, pts2, P, card, torch, np):
    """Phase 12: bench.py's hdiv_hcurl_tri (RT, Nedelec and BDM 1-6 at
    pts2, :799-807) and p2_tri_deg4rule (P2 at the degree-4 rule tiled to
    NPTS points, :786-790) on the f64 engine, K1 + K2 once each a pass."""
    import fiat_tpu_torch as ft
    from fiat_tpu_torch.core.quadrature_schemes import create_quadrature

    hdiv = ([ft.RaviartThomas(T, k) for k in range(1, 7)]
            + [ft.Nedelec(T, k) for k in range(1, 7)]
            + [ft.BrezziDouglasMarini(T, k) for k in range(1, 7)])
    _, kernels = f64_cell("hdiv_hcurl_tri", hdiv, pts2, P, card, torch, np)
    q4 = create_quadrature(T, 4).get_points()
    tiled = np.tile(q4, (NPTS // len(q4) + 1, 1))[:NPTS]
    _, more = f64_cell("p2_tri_deg4rule", [ft.Lagrange(T, 2)], tiled,
                       torch.as_tensor(tiled, device=dev), card, torch, np)
    return kernels + more


def gll_sumfact(PW, F, torch):
    """hex_gll_sumfact's moments (bench.py:535-542): the weighted 1D GLL
    table ``PW`` (p, m) contracted with the (m, m, m) field ``F`` one axis
    at a time, three einsums."""
    t = torch.einsum("aq,qrs->ars", PW, F)
    t = torch.einsum("br,ars->abs", PW, t)
    return torch.einsum("cs,abs->abc", PW, t)


def dense_hex_table(gll, x1, np):
    """hex_gll_sumfact's dense reference as bench.py:554-570 builds it: the
    port's FlattenedDimensions(TensorProductElement(TensorProductElement(
    gll, gll), gll)) tabulated on the host at the tensor grid of the 1D
    points ``x1`` (the first coordinate slowest): the (p^3, m^3) table."""
    from fiat_tpu_torch import FlattenedDimensions, TensorProductElement

    hexel = FlattenedDimensions(TensorProductElement(TensorProductElement(gll, gll), gll))
    xg = np.asarray(x1).ravel()
    grid = np.stack(np.meshgrid(xg, xg, xg, indexing="ij"), axis=-1).reshape(-1, 3)
    return np.asarray(hexel.tabulate(0, grid)[(0, 0, 0)])


def hex_gll_phase(dev, card, torch, np):
    """Phase 13: hex_gll_sumfact as bench.py:515-579 sets it: the GLL
    element of degree HEX_DEGREE on the interval, tabulated on the host at
    the HEX_M-point Gauss-Jacobi rule, and the three sum-factorised einsums
    on the card in float64 on a HEX_M^3 field from default_rng(0), held to
    the port's dense hexahedral element (``dense_hex_table``, tabulated on
    the host) contracted with the tensor-product weights times the field by
    one torch.matmul on the card, at HEX_RTOL of its max, and timed beside
    the einsums' bytes over the HBM rate.  No Pallas kernel runs here in
    fiat_tpu: torch.einsum is the port of its jnp.einsum."""
    from fiat_tpu_torch import GaussLobattoLegendre, ufc_simplex
    from fiat_tpu_torch.core.quadrature import GaussJacobiQuadratureLineRule

    I = ufc_simplex(1)
    gll = GaussLobattoLegendre(I, HEX_DEGREE)
    rule = GaussJacobiQuadratureLineRule(I, HEX_M)
    x1, w1 = rule.get_points(), rule.get_weights()
    phi1 = np.asarray(gll.tabulate(0, x1)[(0,)])
    F_h = np.random.default_rng(0).random((HEX_M,) * 3)
    PW = torch.as_tensor(phi1 * w1, device=dev)
    F = torch.as_tensor(F_h, device=dev)
    M = gll_sumfact(PW, F, torch)
    p, m = phi1.shape
    t0 = time.perf_counter()
    dense = torch.as_tensor(dense_hex_table(gll, x1, np), device=dev)
    dense_s = time.perf_counter() - t0
    w3f = torch.as_tensor((np.einsum("p,q,r->pqr", w1, w1, w1) * F_h).ravel(), device=dev)
    want = torch.matmul(dense, w3f).reshape(p, p, p).cpu().numpy()
    got = M.cpu().numpy()
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"hex_gll_sumfact: GLL {HEX_DEGREE} on the interval ({p} x {m} table at the {m}-point "
          f"Gauss-Jacobi rule), moments {tuple(got.shape)} of a {m}^3 field, finite "
          f"{bool(np.isfinite(got).all())}; vs the port's dense hexahedral element (the "
          f"FlattenedDimensions of GLL x GLL x GLL, {tuple(dense.shape)}, tabulated on the host "
          f"in {dense_s:.2f} s) times w^3 F, one torch.matmul on the card: rel {rel:.3e} "
          f"(bar {HEX_RTOL})")
    if tuple(got.shape) != (p, p, p) or not np.isfinite(got).all() or not rel <= HEX_RTOL:
        fail(f"hex_gll_sumfact: shape {tuple(got.shape)}, rel {rel:.3e} > {HEX_RTOL}")
    ms = median_ms(lambda: gll_sumfact(PW, F, torch), torch)
    card_ms = queued_ms(lambda: gll_sumfact(PW, F, torch), torch)
    dense_ms = median_ms(lambda: torch.matmul(dense, w3f), torch)
    del dense
    # each einsum reads its operands once and writes its output once
    nbytes = 8 * (3 * p * m + m ** 3 + 2 * p * m * m + 2 * p * p * m + p ** 3)
    print(f"hex_gll_sumfact timing ({card}; median of {REPS} runs of {INNER}, CUDA events): "
          f"three einsums {ms:.4f} ms (card, the calls queued behind a spin: {card_ms:.4f} ms); "
          f"their {nbytes} bytes over the HBM rate {nbytes / HBM_BYTES_MS:.6f} ms; the dense "
          f"contraction {dense_ms:.4f} ms")


#: fiat_tpu's own instance list (tests/test_nodality_sweep.py, SPECS at
#: :36-115) cut to the Stokes, elasticity and C2 families, on one cell, in
#: SPECS order: (family, degree or None, keywords); on the tetrahedron the
#: sweep's NodalEnriched-GN (:167) and Walkington (fiat_tpu's parity tests,
#: tests/test_elements_wave2.py:238) follow
STOKES_TRI = (
    ("WuXuH3NC", 4, {}), ("WuXuRobustH3NC", 7, {}), ("BrambleZlamalC2", 9, {}),
    ("BrambleZlamalC2", 10, {}), ("AlfeldC2", 5, {}), ("AlfeldC2", 6, {}),
    ("BernardiRaugel", None, {}), ("MardalTaiWinther", 1, {}), ("ArnoldWintherNC", 2, {}),
    ("ArnoldWinther", 3, {}), ("HuZhang", 3, {}), ("HuZhang", 4, {}),
    ("HuZhang", 3, {"variant": "point"}), ("HuZhang", 4, {"variant": "point"}),
    ("JohnsonMercier", None, {}), ("AlfeldSorokina", None, {}),
    ("ArnoldQin", None, {"reduced": False}), ("ArnoldQin", None, {"reduced": True}),
    ("ChristiansenHu", None, {}), ("GuzmanNeilanFirstKindH1", 1, {}),
    ("GuzmanNeilanSecondKindH1", 1, {}),
)
STOKES_TET = (
    ("BernardiRaugel", None, {}), ("MardalTaiWinther", 1, {}), ("MardalTaiWinther", 2, {}),
    ("JohnsonMercier", None, {}), ("AlfeldSorokina", None, {}), ("ChristiansenHu", None, {}),
    ("GuzmanNeilanFirstKindH1", 1, {}), ("GuzmanNeilanFirstKindH1", 2, {}),
    ("GuzmanNeilanSecondKindH1", 1, {}), ("GuzmanNeilanSecondKindH1", 2, {}),
)
STOKES_TET_TAIL = ("NodalEnriched-GN", "Walkington")
#: the split-variant cells (phases 16-17): the moment families that build
#: on a split through MacroPolynomialSet, on the Alfeld, Powell-Sabin(6/12),
#: Worsey-Farin and Iso(2) splits, the iso variants of Lagrange and DG, and
#: the same families unsplit; one macro program an element
SPLIT_FAMILIES = ("RaviartThomas", "Nedelec", "BrezziDouglasMarini", "CrouzeixRaviart",
                  "NedelecSecondKind", "Regge", "HellanHerrmannJohnson",
                  "GopalakrishnanLedererSchoberlFirstKind",
                  "GopalakrishnanLedererSchoberlSecondKind")
SPLIT_TRI = (
    tuple((fam, 1, split) for fam in SPLIT_FAMILIES
          for split in ("alfeld", "powell-sabin", "powell-sabin(12)", "iso(2)"))
    + tuple(("BrezziDouglasFortinMarini", 2, split)
            for split in ("alfeld", "powell-sabin", "iso(2)"))
    + tuple((fam, 3, split) for fam in ("RaviartThomas", "Nedelec")
            for split in ("alfeld", "iso(2)"))
    + (("Lagrange", 1, "iso"), ("Lagrange", 2, "iso(2)"), ("Lagrange", 3, "iso(3)"),
       ("DiscontinuousLagrange", 1, "iso"))
    + tuple((fam, 1, None) for fam in SPLIT_FAMILIES)
    + (("BrezziDouglasFortinMarini", 2, None),))
SPLIT_TET = (
    tuple((fam, 1, "alfeld") for fam in SPLIT_FAMILIES)
    + tuple((fam, 1, split)
            for fam in ("RaviartThomas", "Nedelec", "CrouzeixRaviart", "NedelecSecondKind")
            for split in ("worsey-farin", "powell-sabin", "iso(2)"))
    + (("Lagrange", 1, "iso"), ("DiscontinuousLagrange", 1, "iso"))
    + tuple((fam, 1, None) for fam in SPLIT_FAMILIES))
#: phase 18, ``iso_refined_tri``: the P1-iso-Pk spaces (Lagrange 1 on the
#: iso(6), iso(8) and iso(10) splits: 36, 64 and 100 subcells a program),
#: Lagrange 2 and 6 and RT, Nedelec and CR 1 on iso(6), and the same
#: families unsplit.  DiscontinuousLagrange(T, 1, "iso(6)") is left out:
#: fiat_tpu's own engine gives NaN at points that its subcells (on the open
#: lattice of DG's default points) leave uncovered near the parent's edges
ISO_TRI = (
    (("Lagrange", 1, "iso(6)"), ("Lagrange", 1, "iso(8)"), ("Lagrange", 1, "iso(10)"),
     ("Lagrange", 2, "iso(6)"), ("Lagrange", 6, "iso(6)"))
    + tuple((fam, 1, "iso(6)") for fam in ("RaviartThomas", "Nedelec", "CrouzeixRaviart"))
    + tuple(("Lagrange", deg, None) for deg in (1, 2, 6))
    + tuple((fam, 1, None) for fam in ("DiscontinuousLagrange", "RaviartThomas", "Nedelec",
                                       "CrouzeixRaviart")))
#: phase 19, ``k3_wide_chunks``: one macro element beside P1 whose K3 tables
#: chunk and Phi tile pass a block's 227 KB (the f64 tables of the first
#: two on K3, the f32 tables of all three; the tet's f64 tables on K7):
#: (name, sd, element)
K3_WIDE = (("k3_wide_ps12_lagrange9", 2, ("Lagrange", 9, "powell-sabin(12)")),
           ("k3_wide_iso5_lagrange10", 2, ("Lagrange", 10, "iso(5)")),
           ("k3_wide_wf_lagrange7_tet", 3, ("Lagrange", 7, "worsey-farin")))
#: phase 29, ``high_degree``: the zoos at the degrees fiat_tpu's kernels take
#: past the port's unrolled instantiations (K1 and K6 unrolled to 15 / 15 /
#: 10 on sd 1 / 2 / 3, K3 and K45 to 15 / 10 / 10), which run each kernel's
#: generic instantiation: GLL Lagrange (Firedrake's spectral default) and DG
#: at the degrees hp and spectral-element users run, RT and N1curl 16 (288
#: dofs each), and Lagrange on the Alfeld splits (K3's generic stage on the
#: interval and the triangle; on the tetrahedron K7 over K1's degree-11 Phi
#: for the f64 tables, K3 for f32 and interpolation).  Tet degree 14 is the
#: last whose basis (680 members) K2 contracts (792)
HIGH_DEGREE = (
    (1, "high_degree_interval", (("Lagrange", 16, "gll"), ("Lagrange", 20, "gll"),
                                 ("Lagrange", 25, "gll"), ("Lagrange", 30, "gll"),
                                 ("DiscontinuousLagrange", 30, None),
                                 ("Lagrange", 20, "alfeld"))),
    (2, "high_degree_tri", (("Lagrange", 11, "gll"), ("Lagrange", 16, "gll"),
                            ("Lagrange", 20, "gll"), ("DiscontinuousLagrange", 20, None),
                            ("RaviartThomas", 16, None), ("Nedelec", 16, None),
                            ("Lagrange", 12, "alfeld"), ("Lagrange", 18, "alfeld"))),
    (3, "high_degree_tet", (("Lagrange", 11, "gll"), ("Lagrange", 14, "gll"),
                            ("DiscontinuousLagrange", 14, None), ("Lagrange", 11, "alfeld"))))
#: phase 29's ElementTabulator cases: (sd, GLL Lagrange degree)
HIGH_DEGREE_ELEMENT = ((2, 20), (3, 14))
#: the first degree that runs a generic instantiation, by sd (K3 and K45
#: past 10 on the triangle): an element of at least this embedded degree is
#: held to host relative to max(1, max |table|), at HOST_ATOL
HIGH_DEGREE_FROM = {1: 16, 2: 11, 3: 11}
#: phase 29's float32 plain rows against its f64 tables, per alpha of its
#: max: the f32 recurrence's rounding grows with the degree (on the CPU, 2000
#: points: 1.1e-5 on the interval, 8.9e-6 on the triangle, 5.8e-6 on the
#: tetrahedron; fiat_tpu's own f32 engine 3.7e-6 at triangle 20 and 3.5e-6
#: at tet 14 on 64), past F32_RTOL: the interval's bar
HIGH_DEGREE_F32_RTOL = 2e-5
#: phase 29's ill-conditioned elements (a bar of their own, as below): the
#: equispaced DG 30 (Lebesgue constant ~1e7, tables to 2.8e8; the port's
#: plain path 1.1e-9 of max(1, max |table|) from host on 2000 points on the
#: CPU), and Lagrange 12 on the Alfeld triangle and 11 on the Alfeld
#: tetrahedron, which both packages' engines tabulate through the extension
#: of each subcell's polynomials to the parent (``MacroSideProgram``'s
#: collocation), whose growth amplifies rounding (the port 4.2e-5 and 5.5e-4
#: on the CPU; fiat_tpu's interpreted engine 2.4e-4 from host at triangle 12)
HIGH_DEGREE_ILL = {"DiscontinuousLagrange 30 UFCInterval": 5e-9,
                   "Lagrange 12 AlfeldSplit": 2e-4, "Lagrange 11 AlfeldSplit": 2e-3}
#: phase 30's elements (WIDE), whose tables grow far past 1 with the
#: degree (the equispaced DG 40's most): their tables held at the high
#: degrees' bar, HOST_ATOL of max(1, max |table|) (1.2e-12 at tet 20,
#: 4.9e-11 and 3.4e-12 at triangle 40 from host, phase 30 on the card), and
#: so their moments on that bar
#: times the sum of the weights and their interpolated values on it times
#: the sum of |c| over their rows (their moments are 1.4e-10 at tet GLL 20,
#: 7.8e-8 and 7.6e-6 at triangle 40 from host in absolute terms)
WIDE_ILL = {f"{family} {degree} {cell}": HOST_ATOL for family, degree, cell in (
    ("Lagrange", 15, "UFCTetrahedron"), ("Lagrange", 16, "UFCTetrahedron"),
    ("Lagrange", 20, "UFCTetrahedron"), ("DiscontinuousLagrange", 20, "UFCTetrahedron"),
    ("Lagrange", 40, "UFCTriangle"), ("DiscontinuousLagrange", 40, "UFCTriangle"))}
#: the elements whose tables keep no digit of the host's: Lagrange 20 on the
#: Alfeld interval and 18 on the Alfeld triangle, whose subcell polynomials
#: grow by ~T_20(3) = 1e15 on their extension to the parent (the port's
#: plain path 1.2e10 and 1.3e2 of max(1, max |table|) from host on the CPU;
#: fiat_tpu's engine likewise, 4.6e9 at interval 20): held to their kernels'
#: plain versions (row by row to max |A_r| |B|) and to finiteness; their
#: distance from host is printed, not held, their moments likewise, and
#: the interpolation held to host zeroes their rows of c (``host_dual_check``)
NO_DIGITS = ("Lagrange 20 AlfeldSplit", "Lagrange 18 AlfeldSplit")
#: ill-conditioned split elements (a high degree on small subcells), whose
#: tables are held to host per alpha relative to max(1, max |table|) at a
#: bar of their own, named by ``split_label``: four to seven times the
#: port's reading and below fiat_tpu's own engine's (PERF.md §2; worst
#: alpha on the CPU, fiat_tpu on 200 points / the port on 2000: Lagrange 6
#: iso(6) 4.0e-5 / 2.9e-7, Lagrange 9 PS12 7.5e-5 / 3.4e-6, Lagrange 10
#: iso(5) 4.0 / 5.0e-2; Lagrange 7 WF 4.2e-9 / 4.9e-9, where host
#: tabulation itself is that far from both); their moments on their table
#: bar times the sum of the weights, their interpolated values on it times
#: the sum of |c| over their rows
ILL_CONDITIONED = {"Lagrange 6 IsoSplit": 2e-6, "Lagrange 9 PowellSabin12Split": 2e-5,
                   "Lagrange 10 IsoSplit": 0.3, "Lagrange 7 WorseyFarinSplit": 2e-8,
                   **HIGH_DEGREE_ILL, **WIDE_ILL}
#: the same elements' float32 tables carry no digit of their f64 tables
#: (fiat_tpu's own f32 engine is 0.47, 2.7, 7.6e4 and 5.4e-3 of max abs + 1
#: from them on 300 points on the CPU): their f32 rows are held to K3
#: float32's plain version and to finiteness, and their distance from the
#: f64 tables is printed, not held
F32_NO_DIGITS = tuple(ILL_CONDITIONED) + NO_DIGITS
#: the elements whose tables are held to host per alpha relative to
#: max(1, max |table|) (fiat_tpu's own engine is 4.3e-10 from host on
#: AlfeldC2 6, 2.3e-11 of that; tests/test_parity_sweep.py:39 holds it to
#: FIAT at 4e-10); every other element is held to HOST_ATOL
STOKES_RELATIVE = ("AlfeldC2",)
STOKES_HOST_RTOL = 1e-9
#: the elements whose moments on HOST_CHECK_PTS points are held to their
#: table bar times the sum of the weights, because their readings need more
#: than HOST_ATOL (PERF.md §2: on the H100, AlfeldC2 5 1.0e-10, AlfeldC2 6
#: 8.8e-9, Walkington 2.0e-10; RT 3 and Nedelec 3 on the Alfeld triangle,
#: named with their split (``split_label``), 1.1e-10 and 9.4e-11 there and
#: 1.12e-10 and 1.26e-10 on the CPU: a degree-3 collocation into the parent
#: basis, as fiat_tpu's device route takes, at 3e-14 of their sums' scale);
#: every other element's are held to HOST_ATOL
SUMMED_MOMENTS = ("AlfeldC2", "Walkington", "RaviartThomas 3 AlfeldSplit",
                  "Nedelec 3 AlfeldSplit")
#: float32 macro rows held to a bar of their own, of max abs + 1 per alpha,
#: about three times their readings (PERF.md §2: on the H100, AlfeldC2 5
#: 5.1e-5, AlfeldC2 6 1.7e-3): AlfeldC2's change of basis cancels far below
#: the float32 rounding of its sums
F32_OWN_BARS = {"AlfeldC2 5": 2e-4, "AlfeldC2 6": 5e-3}
#: phase 20, ``interval_zoo``: the interval families at order 1 (the nodal
#: ones of fiat_tpu's sweep to degree 15, Histopolation, the FDM family, and
#: the split interval elements: 220 elements, 1,937 basis functions, 3.1 GB
#: of f64 tables a pass).  FDMHermite takes degree 3 only (fiat_tpu's own
#: limit: its degree 4-15 raise LinAlgError).  DiscontinuousLagrange 3 on
#: iso(4) is left out, DiscontinuousLagrange 3 on Alfeld in its place:
#: fiat_tpu's own engine gives NaN where the iso subcells (on the open
#: lattice of DG's points) leave the ends of the interval uncovered, as
#: phase 18 found for DG 1 on iso(6).  Lagrange 1 on iso(64) is one program
#: of 64 subcells, two mask words
INTERVAL_ZOO = (
    tuple(("Lagrange", d, None) for d in range(1, 16))
    + tuple(("DiscontinuousLagrange", d, None) for d in range(16))
    + tuple(("GaussLobattoLegendre", d, None) for d in range(1, 16))
    + tuple(("GaussLegendre", d, None) for d in range(16))
    + tuple(("GaussRadau", d, None) for d in range(1, 16))
    + tuple(("Legendre", d, None) for d in range(16))
    + tuple(("IntegratedLegendre", d, None) for d in range(1, 16))
    + (("CubicHermite", None, None),)
    + tuple(("Bubble", d, None) for d in range(2, 16))
    + tuple(("Histopolation", d, None) for d in range(15))
    + tuple((fam, d, None) for fam in ("FDMLagrange", "FDMQuadrature", "FDMBrokenH1")
            for d in range(1, 16))
    + tuple((fam, d, None) for fam in ("FDMDiscontinuousLagrange", "FDMBrokenL2")
            for d in range(15))
    + (("FDMHermite", 3, None),
       ("Lagrange", 1, "iso(2)"), ("Lagrange", 1, "iso(8)"), ("Lagrange", 1, "iso(64)"),
       ("Lagrange", 3, "iso(4)"), ("DiscontinuousLagrange", 3, "alfeld"),
       ("Lagrange", 6, "alfeld")))
#: the single-width sub-zoo of phase 20 on the Bernstein route (K8 + K2)
INTERVAL_BERNSTEIN = (("Lagrange", 15, None), ("DiscontinuousLagrange", 15, None),
                      ("GaussLobattoLegendre", 15, None), ("FDMLagrange", 15, None))
#: the interval's tables are held to host relative to max(1, max |table|) at
#: HOST_ATOL: the degree-15 nodal bases' derivatives reach 1.3e4 there, and
#: the engine's error grows with them (on the CPU the port's plain path
#: reads 3.7e-10 absolute, 2.8e-14 of it, on Lagrange 15; fiat_tpu's own
#: engine is 4.9e-11 of max(1, max |table|) from host on this zoo)
INTERVAL_HOST_RTOL = HOST_ATOL
INTERVAL_KEY = "the interval's elements"
#: the interval's float32 plain rows against its f64 tables, per alpha of
#: its max: the degree-15 equispaced bases (Lagrange, DG, Bubble 15, the
#: alphas' largest rows) cancel in float32 past F32_RTOL (on the CPU on 300
#: points: the port 2.9e-6, fiat_tpu's own f32 engine 3.5e-6; the port
#: 6.5e-6 on 3000), so they are held to about three times that
INTERVAL_F32_RTOL = 2e-5
#: the split interval elements whose float32 macro rows cancel below their
#: float32 rounding, held to a bar of their own of max abs + 1 per alpha, by
#: ``split_label``: Lagrange 3 iso(4) and Lagrange 6 Alfeld at about three
#: times their readings (on the CPU, 2000 points: 6.3e-5 and 1.5e-4;
#: fiat_tpu's own f32 engine 1.7e-5 and 4.3e-5 on 300), and Lagrange 1 on
#: the iso splits, whose iso(64) subcells at the ends are 8.8e-4 wide, so
#: that its parent-basis coefficients reach 1.1e3 and cancel to O(1): its
#: float32 rounding is up to 6.8e-5 (the port 2.2e-5 on 2000 points,
#: fiat_tpu 3.3e-6 on 300), held to about three times that
INTERVAL_F32_BARS = {"Lagrange 1 IsoSplit": 2e-4, "Lagrange 3 IsoSplit": 2e-4,
                     "Lagrange 6 AlfeldSplit": 5e-4}
#: the split interval elements whose moments on HOST_CHECK_PTS points are
#: held to their table bar times the sum of the weights, and their
#: interpolated values to it times the sum of |c| over their rows, by
#: ``split_label`` (on the CPU: 2.0e-9 and 2.3e-10 from host, 2e-12 of their
#: sums' scale; the dual route goes through the parent-basis collocation,
#: as fiat_tpu's device route does, and SUMMED_MOMENTS's elements); every
#: other interval element's moments are held to HOST_ATOL
INTERVAL_SUMMED = ("Lagrange 6 AlfeldSplit", "Lagrange 3 IsoSplit")


def element_label(el):
    """An element's family and degree, as the bars above name it."""
    return f"{type(el).__name__} {el.degree()}"


def split_label(el):
    """``element_label`` and the complex the element's basis lives on, as
    SUMMED_MOMENTS names a split variant."""
    return f"{element_label(el)} {type(el.get_nodal_basis().get_reference_element()).__name__}"


def on_interval(el):
    """Whether ``el`` lives on the interval (phase 20)."""
    return el.get_reference_element().get_spatial_dimension() == 1


def high_degree(el):
    """Whether ``el``'s embedded degree runs a generic instantiation
    (HIGH_DEGREE_FROM)."""
    sd = el.get_reference_element().get_spatial_dimension()
    return el.get_nodal_basis().get_embedded_degree() >= HIGH_DEGREE_FROM.get(sd, 1 << 30)


def table_bar(el, want):
    """An element's bar against host tables ``want``: HOST_ATOL, or for the
    STOKES_RELATIVE elements STOKES_HOST_RTOL of max(1, max |table|), for
    the ILL_CONDITIONED ones their own bar of it, for the interval's
    INTERVAL_HOST_RTOL of it, for phase 29's (``high_degree``) HOST_ATOL of
    it."""
    if split_label(el) in ILL_CONDITIONED:
        return ILL_CONDITIONED[split_label(el)] * max(1.0, float(abs(want).max()))
    if on_interval(el) or high_degree(el):
        return INTERVAL_HOST_RTOL * max(1.0, float(abs(want).max()))
    if type(el).__name__ in STOKES_RELATIVE:
        return STOKES_HOST_RTOL * max(1.0, float(abs(want).max()))
    return HOST_ATOL


def f32_own_bar(el):
    """An element's bar of its own on its float32 macro rows (F32_OWN_BARS by
    ``element_label``, INTERVAL_F32_BARS by ``split_label`` on the
    interval), or None: F32_MACRO_TOL."""
    if on_interval(el):
        return INTERVAL_F32_BARS.get(split_label(el))
    return F32_OWN_BARS.get(element_label(el))


def relative_bar(el):
    """Whether ``table_bar`` holds ``el`` relative to max(1, max |table|)."""
    return (on_interval(el) or type(el).__name__ in STOKES_RELATIVE
            or split_label(el) in ILL_CONDITIONED or high_degree(el))


def stokes_zoo(sd):
    """stokes_elasticity_tri (sd = 2) or stokes_elasticity_tet (sd = 3),
    built by the port."""
    import fiat_tpu_torch as ft
    T = ft.ufc_simplex(sd)
    zoo = [getattr(ft, fam)(T, *(() if deg is None else (deg,)), **kw)
           for fam, deg, kw in (STOKES_TRI if sd == 2 else STOKES_TET)]
    if sd == 3:
        zoo += [composite(name, T) if name != "Walkington" else ft.Walkington(T)
                for name in STOKES_TET_TAIL]
    return zoo


def host_bars(name, zoo, per, pts, npts, np, order=1):
    """Each element's tables against host el.tabulate on the first
    HOST_CHECK_PTS points, each to its ``table_bar``; fails on wrong alphas
    or shapes, or past a bar.  Returns the worst absolute error of the
    elements held to HOST_ATOL."""
    worst_abs, worst_rel, no_digits = 0.0, {}, []
    check = pts[:HOST_CHECK_PTS]
    for el, got in zip(zoo, per):
        want = el.tabulate(order, check)
        if set(want) != set(got):
            fail(f"{type(el).__name__}: alphas {sorted(got)} != {sorted(want)}")
        for a, w in want.items():
            if tuple(got[a].shape) != w.shape[:-1] + (npts,):
                fail(f"{type(el).__name__} {a}: shape {tuple(got[a].shape)}")
            err = float(np.abs(got[a][..., :HOST_CHECK_PTS].cpu().numpy() - w).max())
            if split_label(el) in NO_DIGITS:
                no_digits.append(f"{split_label(el)} {a} "
                                 f"{err / max(1.0, float(np.abs(w).max())):.3e}")
                continue
            bar, key = table_bar(el, w), split_label(el)
            if not err <= bar:
                fail(f"{name}: {key} {a} is {err:.3e} from host el.tabulate > {bar:.3e}")
            if relative_bar(el):
                rel = err / max(1.0, float(np.abs(w).max()))
                if on_interval(el) and key not in ILL_CONDITIONED:
                    key = INTERVAL_KEY      # one reading for the interval's elements
                worst_rel[key] = max(worst_rel.get(key, 0.0), rel)
            else:
                worst_abs = max(worst_abs, err)
    limits = {INTERVAL_KEY: INTERVAL_HOST_RTOL, **ILL_CONDITIONED}
    print(f"{name} main path: block_tables(order {order}) at {npts} points vs host el.tabulate "
          f"on {HOST_CHECK_PTS} points: max abs {worst_abs:.3e} (limit {HOST_ATOL})"
          + "".join(f"; {k} {v:.3e} of max(1, max |table|) per alpha (limit "
                    f"{limits.get(k, STOKES_HOST_RTOL if k.split()[0] in STOKES_RELATIVE else HOST_ATOL)})"
                    for k, v in worst_rel.items())
          + (f"; not held (NO_DIGITS, of max(1, max |table|)): {', '.join(no_digits)}"
             if no_digits else ""))
    return worst_abs


# -- phase 21: the tensor-product cells and the composite elements -------------

#: phase 21, ``tp_zoo``: the product of interval elements held to host on
#: the interval's bar (PERF.md §2), of max(1, max |table|) per alpha
TP_PRODUCT_RTOL = INTERVAL_HOST_RTOL
#: K8 against the Bernstein element's order-0 table, of its max |table|
BERNSTEIN_RTOL = 1e-13
#: the Bernstein elements of phase 21: degrees 1 to these, by sd (the
#: ranges of ops/bernstein.py's MAX_DEGREE)
BERNSTEIN_TOP = {1: 15, 2: 15, 3: 10}


def quad_piola(m, k, curl=False):
    """RTCF k (RTCE k with ``curl``) on I x I, built by the package
    namespace ``m`` (the port, or fiat_tpu in the tests): the
    EnrichedElement of the Hdiv (Hcurl) products CG k x DG k-1 and DG k-1
    x CG k."""
    I = m.ufc_simplex(1)
    CG, DG = m.Lagrange(I, k), m.DiscontinuousLagrange(I, k - 1)
    wrap = m.Hcurl if curl else m.Hdiv
    return m.EnrichedElement(wrap(m.TensorProductElement(CG, DG)),
                             wrap(m.TensorProductElement(DG, CG)))


def hex_piola(m, k, curl=False):
    """NCF k (NCE k with ``curl``) on (I x I) x I: the EnrichedElement of
    Hdiv(RTCF k x DG k-1) and Hdiv(DQ k-1 x CG k) (Hcurl(RTCE k x CG k)
    and Hcurl(Q k x DG k-1))."""
    I = m.ufc_simplex(1)
    CG, DG = m.Lagrange(I, k), m.DiscontinuousLagrange(I, k - 1)
    if curl:
        pairs = ((quad_piola(m, k, curl=True), CG), (m.TensorProductElement(CG, CG), DG))
    else:
        pairs = ((quad_piola(m, k), DG), (m.TensorProductElement(DG, DG), CG))
    wrap = m.Hcurl if curl else m.Hdiv
    return m.EnrichedElement(*[wrap(m.TensorProductElement(a, b)) for a, b in pairs])


def tp_product(m, k, sd, continuous=True):
    """Q k (DQ k unless ``continuous``) on the quadrilateral (sd 2) or the
    hexahedron (sd 3): the FlattenedDimensions of the product of sd
    interval elements, CG k (DG k)."""
    I = m.ufc_simplex(1)
    family = m.Lagrange if continuous else m.DiscontinuousLagrange
    el = m.TensorProductElement(family(I, k), family(I, k))
    if sd == 3:
        el = m.TensorProductElement(el, family(I, k))
    return m.FlattenedDimensions(el)


def tp_zoo(m):
    """Phase 21's zoo built by the package namespace ``m``: {group: [(label,
    element)]} for "quadrilateral" and "hexahedron" (tabulated in the unit
    square and cube), "trace" (HDivTrace on I x I, tabulated on its
    facets) and "composite" (on the triangle).  The Q and DQ entries are
    the plain products of the product check."""
    I, Q, H = m.ufc_simplex(1), m.UFCQuadrilateral(), m.UFCHexahedron()
    T = m.ufc_simplex(2)
    quad = ([(f"Q {k}", tp_product(m, k, 2)) for k in range(1, 9)]
            + [(f"DQ {k}", tp_product(m, k, 2, False)) for k in range(7)]
            + [(f"RTCF {k}", quad_piola(m, k)) for k in range(1, 5)]
            + [(f"RTCE {k}", quad_piola(m, k, curl=True)) for k in range(1, 5)]
            + [(f"S {k}", m.Serendipity(Q, k)) for k in range(1, 7)]
            + [(f"DPC {k}", m.DPC(Q, k)) for k in range(7)]
            + [(f"SminusF {k}", m.TrimmedSerendipityFace(Q, k)) for k in range(1, 4)]
            + [(f"SminusE {k}", m.TrimmedSerendipityEdge(Q, k)) for k in range(1, 4)]
            + [(f"BDMCF {k}", m.BrezziDouglasMariniCubeFace(Q, k)) for k in range(1, 4)]
            + [(f"BDMCE {k}", m.BrezziDouglasMariniCubeEdge(Q, k)) for k in range(1, 4)])
    hexa = ([(f"Q {k}", tp_product(m, k, 3)) for k in range(1, 5)]
            + [(f"DQ {k}", tp_product(m, k, 3, False)) for k in range(4)]
            + [(f"NCF {k}", hex_piola(m, k)) for k in range(1, 3)]
            + [(f"NCE {k}", hex_piola(m, k, curl=True)) for k in range(1, 3)]
            + [(f"S {k}", m.Serendipity(H, k)) for k in range(1, 5)]
            + [(f"DPC {k}", m.DPC(H, k)) for k in range(4)]
            + [(f"SminusE {k}", m.TrimmedSerendipityEdge(H, k)) for k in range(1, 4)])
    trace = [(f"HDivTrace {k}", m.HDivTrace(m.TensorProductCell(I, I), k)) for k in range(4)]
    composite = [("MixedElement (Lagrange 2, RaviartThomas 2)",
                  m.MixedElement([m.Lagrange(T, 2), m.RaviartThomas(T, 2)])),
                 ("MixedElement (DiscontinuousLagrange 1, Lagrange 3)",
                  m.MixedElement([m.DiscontinuousLagrange(T, 1), m.Lagrange(T, 3)])),
                 ("QuadratureElement (degree 4 rule)",
                  m.QuadratureElement(T, m.create_quadrature(T, 4).get_points()))]
    return {"quadrilateral": quad, "hexahedron": hexa, "trace": trace, "composite": composite}


def tp_points(n, seed, np):
    """Phase 21's points: {group: (n, sd)} uniform in the unit square and
    the unit cube (default_rng(seed), square first), their first column as
    points of the interval facets of I x I (``trace``), and pts2 in the
    triangle (``composite``)."""
    rng = np.random.default_rng(seed)
    square, cube = rng.random((n, 2)), rng.random((n, 3))
    return {"quadrilateral": square, "hexahedron": cube, "trace": square[:, :1],
            "composite": make_points(n, seed, np)}


def tp_factors(el):
    """The interval factors of a plain product (a FlattenedDimensions of
    nested TensorProductElements), in coordinate order."""
    el = getattr(el, "element", el)
    if hasattr(el, "A") and hasattr(el, "B"):
        return tp_factors(el.A) + tp_factors(el.B)
    return [el]


def kron_tables(tabs, order, torch):
    """The tables of a product of interval elements from its factors'
    {(a,): (n_f, npts)} tables ``tabs`` (coordinate order): for every alpha
    of total order <= ``order``, the Kronecker product over the factors of
    their alpha_i-th derivatives, the last factor fastest, as the product
    element numbers its basis."""
    from fiat_tpu_torch.core.expansions import mis

    d = len(tabs)
    letters = "abc"[:d]
    spec = ",".join(c + "p" for c in letters) + "->" + letters + "p"
    out = {}
    for total in range(order + 1):
        for alpha in mis(d, total):
            t = torch.einsum(spec, *[tab[(a,)] for tab, a in zip(tabs, alpha)])
            out[alpha] = t.reshape(-1, t.shape[-1])
    return out


def tp_host_tables(zoo, pts, np, check=HOST_CHECK_PTS):
    """Every element of ``tp_zoo`` tabulated at order 1 on the host at the
    first ``check`` points of its group (HDivTrace on each facet of I x I;
    QuadratureElement at order 0 at its own points, the only tabulation it
    has), each table held finite, each FlattenedDimensions to its
    TensorProductElement and each MixedElement's blocks to its members'
    tables.  Returns ({(group, label): table dict}, seconds)."""
    from fiat_tpu_torch import FlattenedDimensions, MixedElement, QuadratureElement
    from fiat_tpu_torch.elements.hdiv_trace import TraceError

    tables, t0 = {}, time.perf_counter()
    for group, members in zoo.items():
        x = pts[group][:check]
        for label, el in members:
            key = f"{group} {label}"
            if isinstance(el, QuadratureElement):
                own = np.asarray(el._points)
                tab = el.tabulate(0, own)
                if not np.array_equal(tab[(0, 0)], np.eye(len(own))):
                    fail(f"{key}: not the identity at its own points")
            elif group == "trace":
                tab = {}
                for dim in ((0, 1), (1, 0)):
                    for e in sorted(el.entity_dofs()[dim]):
                        ft = el.tabulate(1, x, (dim, e))
                        if not all(isinstance(v, TraceError) for a, v in ft.items() if sum(a)):
                            fail(f"{key}: a derivative on facet {(dim, e)} is not a TraceError")
                        tab[(dim, e)] = ft[(0, 0)]
            else:
                tab = el.tabulate(1, x)
            if not all(np.isfinite(v).all() for v in tab.values()):
                fail(f"{key}: non-finite host values")
            if isinstance(el, FlattenedDimensions):
                inner = el.element.tabulate(1, x)
                if set(inner) != set(tab) or not all(np.array_equal(inner[a], tab[a])
                                                      for a in tab):
                    fail(f"{key}: FlattenedDimensions differs from its TensorProductElement")
            if isinstance(el, MixedElement):
                rows = cols = 0
                for sub in el.elements():
                    st = sub.tabulate(1, x)
                    n, c = sub.space_dimension(), max(int(np.prod(sub.value_shape())), 1)
                    for a, v in st.items():
                        block = tab[a][rows:rows + n, cols:cols + c]
                        if not np.array_equal(block, v.reshape(n, c, -1)):
                            fail(f"{key}: a block differs from its member's table")
                    rows, cols = rows + n, cols + c
            tables[key] = tab
    return tables, time.perf_counter() - t0


def tp_product_cell(zoo, pts, host, dev, card, torch, np):
    """The product check (K1 at sd = 1 and K2): the interval factors of
    every plain product in ``zoo`` (Q and DQ on both cells) through
    ``device_tabulator(factors, order=1)`` on the card, one ``block_tables``
    call at each column of the quadrilateral's and the hexahedron's 1e5
    points (one K1 and one K2 launch each), the Kronecker products of the
    factor tables formed on the card by torch.einsum and held to the host
    TensorProductElement tables ``host`` at TP_PRODUCT_RTOL of max(1, max
    |table|) per alpha; K1 and K2 against their plain versions and timed.
    Returns the kernels-line entries."""
    from fiat_tpu_torch import device_tabulator

    products = [(group, label, el) for group in ("quadrilateral", "hexahedron")
                for label, el in zoo[group] if label.split()[0] in ("Q", "DQ")]
    factors, index = [], {}
    for _, _, el in products:
        for f in tp_factors(el):
            key = (type(f).__name__, f.degree())
            if key not in index:
                index[key] = len(factors)
                factors.append(f)
    t0 = time.perf_counter()
    tab = device_tabulator(factors, order=1)       # the default device: the card
    rec, mm = tab.recurrence, tab.matmul
    if merged_macro(tab) is not None or tab.features is not None or tab.device != dev:
        fail(f"tp_zoo factors: K1 and K2 only, on {dev}")
    cols = {(group, i): torch.as_tensor(np.ascontiguousarray(pts[group][:, i:i + 1]), device=dev)
            for group, sd in (("quadrilateral", 2), ("hexahedron", 3)) for i in range(sd)}
    print(f"tp_zoo product check: {len(products)} products of {len(factors)} interval factors "
          f"({tab.rows} rows, widths {tab.widths}), K1 sd {rec.sd} degree {rec.degree}, "
          f"{len(cols)} columns of {NPTS} points; {time.perf_counter() - t0:.2f} s")
    P = cols[("quadrilateral", 0)]
    phi_p = rec.plain(P)
    k1_abs = check_kernel(f"tp_zoo factors K1 recurrence (sd 1, degree {rec.degree}) at {NPTS} "
                          f"points", rec(P), phi_p, torch)
    k2_abs = check_kernel(f"tp_zoo factors K2 bucket matmul ({mm.total_rows} x {NPTS})",
                          mm(phi_p), mm.plain(phi_p), torch)
    del phi_p
    engines = {"K1": rec, "K2": mm}
    blocks, launches = counted(engines, lambda: {c: tab.block_tables(C) for c, C in cols.items()},
                               torch)
    expect_launches("tp_zoo factors", launches, dict.fromkeys(engines, len(cols)))
    per = {c: tab.unpack(b) for c, b in blocks.items()}
    worst = 0.0
    for group, label, el in products:
        tabs = [per[(group, i)][index[(type(f).__name__, f.degree())]]
                for i, f in enumerate(tp_factors(el))]
        got = kron_tables(tabs, 1, torch)
        want = host[f"{group} {label}"]
        if set(got) != set(want):
            fail(f"tp_zoo {group} {label}: alphas {sorted(got)} != {sorted(want)}")
        for a, w in want.items():
            g = got[a]
            if tuple(g.shape) != (w.shape[0], NPTS) or not bool(torch.isfinite(g).all()):
                fail(f"tp_zoo {group} {label} {a}: shape {tuple(g.shape)} or non-finite values")
            rel = float(np.abs(g[:, :w.shape[1]].cpu().numpy() - w).max()) / max(
                1.0, float(np.abs(w).max()))
            if not rel <= TP_PRODUCT_RTOL:
                fail(f"tp_zoo {group} {label} {a}: {rel:.3e} of max(1, max |table|) from host "
                     f"> {TP_PRODUCT_RTOL}")
            worst = max(worst, rel)
    print(f"tp_zoo product check: the Kronecker products of the factor tables vs host "
          f"TensorProductElement.tabulate on {HOST_CHECK_PTS} points: {worst:.3e} of max(1, "
          f"max |table|) per alpha (bar {TP_PRODUCT_RTOL})")
    del blocks, per
    torch.cuda.empty_cache()

    def product_pass():
        per = {c: tab.unpack(tab.block_tables(C)) for c, C in cols.items()}
        return [kron_tables([per[(group, i)][index[(type(f).__name__, f.degree())]]
                             for i, f in enumerate(tp_factors(el))], 1, torch)
                for group, _, el in products]

    phi = rec(P)
    k1_ms, k1_plain = median_ms(lambda: rec(P), torch), plain_ms(lambda: rec.plain(P), torch)
    k2_ms, k2_plain = median_ms(lambda: mm(phi), torch), plain_ms(lambda: mm.plain(phi), torch)
    A = mm.A.to(dev)
    k2_lib = median_ms(lambda: torch.matmul(A, phi[:mm.max_k]), torch)     # one padded DGEMM
    k1_card, k2_card = queued_ms(lambda: rec(P), torch), queued_ms(lambda: mm(phi), torch)
    del A, phi
    pass_ms = median_ms(product_pass, torch, reps=3, inner=3, warmup=1)
    k1_bound, k2_bound = rec_bound(rec, NPTS), matmul_bound(mm, NPTS)
    print(f"tp_zoo product timing ({card}; median of {REPS} runs of {INNER}, CUDA events; card: "
          f"the same queued behind a spin): the factor tables at {len(cols)} columns and every "
          f"product's Kronecker tables {pass_ms:.4f} ms; a column's K1 {k1_ms:.4f} ms (card "
          f"{k1_card:.4f}, plain {k1_plain:.4f}, bound {k1_bound[0]:.4f} by {k1_bound[1]}), K2 "
          f"{k2_ms:.4f} ms = {k2_rates(mm, k2_ms)} (card {k2_card:.4f}, plain {k2_plain:.4f}, one "
          f"padded DGEMM {k2_lib:.4f}, bound {k2_bound[0]:.4f} by {k2_bound[1]})")
    src = "fiat_tpu_torch/csrc/"
    return [entry("K1 dubiner1_values (tp_zoo factors)", src + "recurrence.cu",
                  "fiat_tpu/ops/pallas_recurrence.py:399", launches["K1"], k1_abs, k1_ms,
                  k1_plain, k1_bound),
            entry("K2 bucket_matmul (tp_zoo factors)", src + "bucket_matmul.cu",
                  "fiat_tpu/ops/pallas_multiword.py:269", launches["K2"], k2_abs, k2_ms,
                  k2_plain, k2_bound, k2_lib)]


def bernstein_rows(sd, degree):
    """The permutation taking K8's rows (``bernstein_multiindices``) to the
    Bernstein element's (``mis(sd + 1, degree)``), by exponent tuple."""
    from fiat_tpu_torch.core.expansions import mis
    from fiat_tpu_torch.ops.bernstein import bernstein_multiindices

    k8 = {tuple(k): i for i, k in enumerate(bernstein_multiindices(sd, degree))}
    return [k8[tuple(k)] for k in mis(sd + 1, degree)]


def bernstein_element_cell(dev, card, torch, np, degrees=None, label="bernstein_element"):
    """The Bernstein check (K8): ``Bernstein(cell, d)`` at the ``degrees``
    of each sd (by default 1-15 on the interval and the triangle and 1-10
    on the tetrahedron, BERNSTEIN_TOP), and
    ``BernsteinFeatures(sd, d, _bary_map(cell), device)`` on the card at
    the 1e5 points of the cell (``make_points``), one launch each, its rows
    permuted to the element's, held to ``Bernstein.tabulate(0, .)`` on the
    first HOST_CHECK_PTS points and to its plain version at BERNSTEIN_RTOL
    of max |table|; each timed against its bound.  Returns the
    kernels-line entries, one a cell at its top degree."""
    from fiat_tpu_torch import Bernstein, ufc_simplex
    from fiat_tpu_torch.ops.bernstein import BernsteinFeatures, _bary_map

    if degrees is None:
        degrees = {sd: range(1, top + 1) for sd, top in BERNSTEIN_TOP.items()}
    t0 = time.perf_counter()
    cells = {}
    for sd, ds in degrees.items():
        cell = ufc_simplex(sd)
        pts = make_points(NPTS, SEED, np, sd=sd)
        cells[sd] = (pts, torch.as_tensor(pts, device=dev),
                     [(Bernstein(cell, d), BernsteinFeatures(sd, d, _bary_map(cell), device=dev))
                      for d in ds])
    print(f"{label} host construction: {sum(map(len, degrees.values()))} Bernstein elements "
          f"(sd 1-3 at degrees {({sd: list(ds) for sd, ds in degrees.items()})}), "
          f"{time.perf_counter() - t0:.2f} s")
    engines = {(sd, feat.degree): feat for sd, (_, _, els) in cells.items() for _, feat in els}
    outs, launches = counted(engines, lambda: {(sd, feat.degree): feat(P) for sd, (_, P, els)
                                               in cells.items() for _, feat in els}, torch)
    if set(launches.values()) != {1}:
        fail(f"{label}: one K8 launch an element, got {launches}")
    print(f"{label} launches on the main path: {len(launches)} K8 calls, one launch "
          f"each")
    entries, src = [], "fiat_tpu_torch/csrc/"
    for sd, (pts, P, els) in cells.items():
        for el, feat in els:
            d = feat.degree
            got = outs[(sd, d)][bernstein_rows(sd, d)]
            want = el.tabulate(0, pts[:HOST_CHECK_PTS])[(0,) * sd]
            if tuple(got.shape) != (want.shape[0], NPTS) or not bool(torch.isfinite(got).all()):
                fail(f"{label} sd {sd} degree {d}: shape {tuple(got.shape)} or "
                     f"non-finite values")
            host = float(np.abs(got[:, :HOST_CHECK_PTS].cpu().numpy() - want).max()
                         / np.abs(want).max())
            k8_abs, plain_rel = rel_err(outs[(sd, d)], feat.plain(P))
            if not (host <= BERNSTEIN_RTOL and plain_rel <= BERNSTEIN_RTOL):
                fail(f"{label} sd {sd} degree {d}: {host:.3e} from the element, "
                     f"{plain_rel:.3e} from its plain version, of max |table| > {BERNSTEIN_RTOL}")
            k8_ms, k8_plain = median_ms(lambda: feat(P), torch), plain_ms(lambda: feat.plain(P),
                                                                          torch)
            k8_card, bound = queued_ms(lambda: feat(P), torch), features_bound(feat, NPTS)
            print(f"{label} sd {sd} degree {d} ({feat.nexp} rows): K8 vs "
                  f"Bernstein.tabulate(0) on {HOST_CHECK_PTS} points {host:.3e}, vs plain "
                  f"{plain_rel:.3e} of max |table| (bar {BERNSTEIN_RTOL}); K8 {k8_ms:.4f} ms "
                  f"(card {k8_card:.4f}, plain {k8_plain:.4f}, bound {bound[0]:.4f} by "
                  f"{bound[1]}; {card})")
            if d == max(degrees[sd]):
                entries.append(entry(f"K8 bernstein_features{generic(feat)} ({label} sd {sd}, "
                                     f"degree {d})", src + "bernstein.cu",
                                     "fiat_tpu/ops/pallas_bernstein.py:288",
                                     launches[(sd, d)], k8_abs, k8_ms, k8_plain, bound))
    return entries


def tp_phase(dev, card, torch, np):
    """Phase 21, ``tp_zoo``: the tensor-product cells and the composite
    elements.  The zoo of ``tp_zoo`` built on the host and tabulated at
    order 1 there (``tp_host_tables``), the host's time at 1e5 points of
    the largest products (Q 8 on the quadrilateral, Q 4 on the
    hexahedron), the product check on K1 and K2 (``tp_product_cell``) and
    the Bernstein check on K8 (``bernstein_element_cell``).  Returns the
    kernels-line entries."""
    import fiat_tpu_torch as ft

    t0 = time.perf_counter()
    zoo = tp_zoo(ft)
    sizes = {g: sum(el.space_dimension() for _, el in members) for g, members in zoo.items()}
    print(f"tp_zoo host construction: {sum(len(v) for v in zoo.values())} elements "
          f"({', '.join(f'{g} {len(v)}' for g, v in zoo.items())}; basis functions {sizes}), "
          f"{time.perf_counter() - t0:.2f} s")
    pts = tp_points(NPTS, SEED, np)
    host, host_s = tp_host_tables(zoo, pts, np)
    print(f"tp_zoo host tables: every element at order 1 on {HOST_CHECK_PTS} points (HDivTrace "
          f"on each facet of I x I, derivatives TraceError), finite; FlattenedDimensions equal "
          f"to its TensorProductElement; MixedElement blocks equal to their members' tables; "
          f"{host_s:.2f} s")
    for group, label in (("quadrilateral", "Q 8"), ("hexahedron", "Q 4")):
        el = dict(zoo[group])[label]
        s0 = time.perf_counter()
        el.tabulate(1, pts[group])
        print(f"tp_zoo host time: {group} {label} ({el.space_dimension()} functions) at order "
              f"1 at {NPTS} points: {time.perf_counter() - s0:.3f} s")
    kernels = tp_product_cell(zoo, pts, host, dev, card, torch, np)
    torch.cuda.empty_cache()
    return kernels + bernstein_element_cell(dev, card, torch, np)


def k3_cells(dev, card, torch, np, own):
    """``python3 chip_smoke.py --k3-cells ROOT``: K3 alone in every cell
    that launches it, on the fiat_tpu_torch package of the checkout at ROOT
    (this one, or another commit's unpacked beside it, to compare the two
    on one card in one call), K7 on sv_macro_tet's f64 tables, and the
    interpolate_rows passes of full_zoo and sv_macro_tet (K1 + K3, host
    bound at these sizes); the same points and shapes as the main run: the
    earlier cells (full_zoo, the C1 zoos, sv_macro_tet, the Stokes and split
    cells) and phases 18-20's.
    Prints {"k3_cells": {cell: [ms, device ms, host ms, K3 ms]}}: CUDA
    events over back-to-back calls (host time of the wrapper included where
    it exceeds the kernel's), torch.profiler's device time alone, the
    host's time to issue one call, and the device time of K3's kernel
    alone (without the call's other kernels).  Where ROOT is
    another checkout (``own`` False), a cell its package refuses records
    the error message; in this checkout every cell must run."""
    import fiat_tpu_torch as ft
    from fiat_tpu_torch import device_tabulator, ufc_simplex
    from fiat_tpu_torch.ops import moments as mo
    from fiat_tpu_torch.ops.tabulate import BatchedTabulator

    T, T3 = ufc_simplex(2), ufc_simplex(3)
    P = torch.as_tensor(make_points(NPTS, SEED, np), device=dev)
    P3 = torch.as_tensor(make_points(NPTS, SEED, np, sd=3), device=dev)
    c1 = [ft.CubicHermite(T), ft.Morley(T), ft.Argyris(T, 5), ft.Bell(T),
          ft.HsiehCloughTocher(T, 3), ft.QuadraticPowellSabin6(T), ft.QuadraticPowellSabin12(T)]
    split_tri, iso_tri = families_zoo(SPLIT_TRI, (), T), families_zoo(ISO_TRI, (), T)

    def tables(zoo, order, Q, f64=True):
        m3 = merged_macro(device_tabulator(zoo, order=order, f64=f64, device=dev))
        Q = Q if f64 else Q.float()
        return lambda: m3(Q)

    def interpolation(zoo, Q):
        eng = mo.moment_engine(BatchedTabulator(zoo, order=0, device=dev))
        c = torch.as_tensor(np.random.default_rng(11).random(eng.rows) - 0.5, device=dev)
        W = eng.program_columns[0] * (c @ eng.matrix)[eng.nexp:]
        return lambda: merged_macro(eng)(Q, A=W)

    def interpolation_pass(zoo, Q):
        bt = BatchedTabulator(zoo, order=0, device=dev)
        c = torch.as_tensor(np.random.default_rng(11).random(mo.moment_engine(bt).rows) - 0.5,
                            device=dev)
        return lambda: mo.interpolate_rows(bt, Q, c)

    def k7_tables(zoo, Q):
        tab = device_tabulator(zoo, order=1, device=dev)
        phi = tab.recurrence(Q)
        return lambda: merged_macro(tab)(Q, phi)

    cells = {"full_zoo": lambda: tables(full_zoo(T), 1, P),
             "full_zoo f32": lambda: tables(full_zoo(T), 1, P, f64=False),
             "full_zoo interpolation": lambda: interpolation(full_zoo(T), P),
             "c1_macro_zoo": lambda: tables(c1, 1, P),
             "c1_macro_hessians": lambda: tables(c1, 2, P),
             "c1_macro_zoo order 3": lambda: tables(c1, 3, P),
             "sv_macro_tet f32": lambda: tables(sv_macro_tet(T3), 1, P3, f64=False),
             "sv_macro_tet interpolation": lambda: interpolation(sv_macro_tet(T3), P3),
             "sv_macro_tet K7": lambda: k7_tables(sv_macro_tet(T3), P3),
             "full_zoo interpolate_rows pass": lambda: interpolation_pass(full_zoo(T), P),
             "sv_macro_tet interpolate_rows pass": lambda: interpolation_pass(sv_macro_tet(T3),
                                                                              P3),
             "stokes_elasticity_tri f32": lambda: tables(stokes_zoo(2), 1, P, f64=False),
             "stokes_elasticity_tri interpolation": lambda: interpolation(stokes_zoo(2), P),
             "stokes_elasticity_tet f32": lambda: tables(stokes_zoo(3), 1, P3, f64=False),
             "split_variants_tri f32": lambda: tables(split_tri, 1, P, f64=False),
             "split_variants_tet f32": lambda: tables(families_zoo(SPLIT_TET, (), T3), 1, P3,
                                                      f64=False),
             "split_variants_tri interpolation": lambda: interpolation(split_tri, P),
             "iso_refined_tri f32": lambda: tables(iso_tri, 1, P, f64=False),
             "iso_refined_tri interpolation": lambda: interpolation(iso_tri, P)}
    I = ufc_simplex(1)
    P1 = torch.as_tensor(make_points(NPTS, SEED, np, sd=1), device=dev)
    cells["interval_zoo f64"] = lambda: tables(families_zoo(INTERVAL_ZOO, (), I), 1, P1)
    cells["interval_zoo f32"] = lambda: tables(families_zoo(INTERVAL_ZOO, (), I), 1, P1,
                                               f64=False)
    cells["interval_zoo interpolation"] = lambda: interpolation(
        families_zoo(INTERVAL_ZOO, (), I), P1)
    for name, sd, spec in K3_WIDE:
        zoo = families_zoo((("Lagrange", 1, None), spec), (), ufc_simplex(sd))
        Q = P if sd == 2 else P3
        if sd == 2:
            cells[f"{name} f64"] = lambda zoo=zoo, Q=Q: tables(zoo, 1, Q)
        cells[f"{name} f32"] = lambda zoo=zoo, Q=Q: tables(zoo, 1, Q, f64=False)
        cells[f"{name} interpolation"] = lambda zoo=zoo, Q=Q: interpolation(zoo, Q)

    def with_host_time(make):
        def made():
            run = make()
            return run, lambda ev, dev_ms: [host_ms(run, torch),
                                            kernel_ms(run, torch, "macro_oneshot")]
        return made

    time_cells("k3_cells", "host time; K3's kernel alone",
               {name: with_host_time(make) for name, make in cells.items()}, card, torch, own)
    if own:     # every candidate plan of K3's tables in the cells that stream or fill a block
        plans = {}
        for name, zoo, Q, f64 in (
                ("full_zoo", full_zoo(T), P, True),
                ("c1_macro_zoo order 3", c1, P, True),
                ("stokes_elasticity_tet f32", stokes_zoo(3), P3, False),
                ("split_variants_tri f32", split_tri, P, False),
                ("iso_refined_tri f32", iso_tri, P, False),
                ("k3_wide_ps12_lagrange9 f64", families_zoo(
                    (("Lagrange", 1, None), K3_WIDE[0][2]), (), T), P, True),
                ("k3_wide_iso5_lagrange10 f32", families_zoo(
                    (("Lagrange", 1, None), K3_WIDE[1][2]), (), T), P, False),
                ("k3_wide_wf_lagrange7_tet f32", families_zoo(
                    (("Lagrange", 1, None), K3_WIDE[2][2]), (), T3), P3, False)):
            order = 3 if name.startswith("c1") else 1
            m3 = merged_macro(device_tabulator(zoo, order=order, f64=f64, device=dev))
            Qd = Q if f64 else Q.float()
            mine, plans[name] = m3.plan, []
            for plan, nbytes in m3.plan_candidates():
                m3.plan = plan
                plans[name].append([list(plan), nbytes, queued_ms(lambda: m3(Qd), torch),
                                    plan == mine])
            m3.plan = mine
            print(f"{name} K3 plans ({card}; [plan, bytes a block, ms queued behind a spin, "
                  f"the wrapper's]): {plans[name]}")
        print(json.dumps({"k3_plans": plans}))


#: the streamed K2's and the wide K6's plans timed by ``--k2-cells`` and
#: ``--k6-cells`` on tet GLL Lagrange 20: (chunk rows, chunks in the ring, row
#: tiles a group; None: the wrapper's group)
STREAM_PLANS = ((32, 2, None), (24, 3, None), (36, 2, None), (16, 4, None), (32, 2, 4),
                (32, 2, 1 << 20))
WIDE_PLANS = ((36, 3, None), (48, 2, None), (24, 4, None), (16, 4, None), (36, 3, 1 << 20))


def time_cells(label, extra, cells, card, torch, own):
    """Time each cell of ``cells`` ({name: make}, make() -> (run, more)):
    CUDA events over back-to-back run() calls and torch.profiler's device
    time alone, followed by ``more(events ms, device ms)`` (``extra`` says
    what).  Where the package is another checkout's (``own`` False), a cell
    it refuses records the error message; in this checkout every cell must
    run.  Prints {label: {cell: [ms, device ms, ...]}}."""
    out = {}
    for name, make in cells.items():
        try:
            run, more = make()
            run()
            torch.cuda.synchronize()
        except Exception as exc:    # another checkout may lack a family or refuse a cell
            if own:
                raise
            out[name] = f"raises {type(exc).__name__}: {(str(exc).splitlines() or [''])[0][:160]}"
        else:
            ev, dev_ms = median_ms(run, torch), device_ms(run, torch)
            out[name] = [ev, dev_ms] + more(ev, dev_ms)
        print(f"{name} ({card}; median of {REPS} runs of {INNER}, CUDA events; profiler "
              f"device time; {extra}): {out[name]}")
    print(json.dumps({label: out}))


def k2_cells(dev, card, torch, np, own):
    """``python3 chip_smoke.py --k2-cells ROOT``: K2 alone in every cell that
    launches it (full_zoo, tet_lagrange8 on K1's Phi and on K8's Bernstein
    features, hdiv_hcurl_tet, sv_macro_tet, c1_macro_zoo, c1_macro_hessians)
    on the fiat_tpu_torch package of the checkout at ROOT, at the points
    and shapes of the main run, each beside one cuBLAS DGEMM of the same
    packed A by the same Phi (zero-padded to the widest width where the
    cell has several).  Prints {"k2_cells": {cell: [ms, device ms, DGEMM
    ms, TFLOP/s, TB/s of C]}}, the rates at the device time.  Also tet GLL
    Lagrange 20 (phase 30: K 1771, the streamed mode; a checkout that
    refuses it records the refusal) and, on this checkout, {"k2_stream_plans":
    {(chunk rows, chunks in the ring, row tiles a group): device ms}} there
    (STREAM_PLANS, the wrapper's own first)."""
    import fiat_tpu_torch as ft
    from fiat_tpu_torch import device_tabulator, ufc_simplex
    from fiat_tpu_torch.ops.fused_zoo import FusedZooTabulator
    from fiat_tpu_torch.ops.tabulate import BatchedTabulator

    T, T3 = ufc_simplex(2), ufc_simplex(3)
    P = torch.as_tensor(make_points(NPTS, SEED, np), device=dev)
    P3 = torch.as_tensor(make_points(NPTS, SEED, np, sd=3), device=dev)
    lag8, hdiv = tet_zoos(T3)
    c1 = [ft.CubicHermite(T), ft.Morley(T), ft.Argyris(T, 5), ft.Bell(T),
          ft.HsiehCloughTocher(T, 3), ft.QuadraticPowellSabin6(T), ft.QuadraticPowellSabin12(T)]

    stream_plans = {}

    def k2(tab, Q):
        mm = tab.matmul
        basis = (tab.features if tab.recurrence is None else tab.recurrence)(Q)
        A = mm.A.to(dev)

        def more(ev, dev_ms):
            ms = dev_ms or ev
            lib = median_ms(lambda: torch.matmul(A, basis[:mm.max_k]), torch)
            if own and getattr(mm, "mode", None) == "streamed":
                mine = (mm.plan, mm.group)
                for kc, stages, group in [(mine[0][1], mine[0][2], mine[1])] + [
                        p for p in STREAM_PLANS if p != (mine[0][1], mine[0][2], mine[1])]:
                    mm.plan, mm.group = (mine[0][0], kc, stages, mine[0][3]), group or mine[1]
                    stream_plans[str((kc, stages, mm.group))] = device_ms(lambda: mm(basis),
                                                                          torch)
                mm.plan, mm.group = mine
            return [lib, matmul_flops(mm, NPTS) / ms / 1e9, mm.total_rows * NPTS * 8 / ms / 1e9]
        return lambda: mm(basis), more

    cells = {
        "full_zoo": lambda: k2(device_tabulator(full_zoo(T), order=1, device=dev), P),
        "tet_lagrange8": lambda: k2(device_tabulator(lag8, order=1, device=dev), P3),
        "tet_lagrange8 bernstein": lambda: k2(FusedZooTabulator(
            BatchedTabulator(lag8, order=1, device="cpu"), device=dev, features="bernstein"), P3),
        "hdiv_hcurl_tet": lambda: k2(device_tabulator(hdiv, order=1, device=dev), P3),
        "sv_macro_tet": lambda: k2(device_tabulator(sv_macro_tet(T3), order=1, device=dev), P3),
        "c1_macro_zoo": lambda: k2(device_tabulator(c1, order=1, device=dev), P),
        "c1_macro_hessians": lambda: k2(device_tabulator(c1, order=2, device=dev), P),
        "tet_gll20": lambda: k2(device_tabulator(
            [ft.Lagrange(T3, 20, variant="gll")], order=1, device=dev), P3)}
    time_cells("k2_cells", "one cuBLAS DGEMM ms; TFLOP/s and TB/s of C at the device time",
               cells, card, torch, own)
    if own:
        print(json.dumps({"k2_stream_plans": stream_plans}))


def k45_cells(dev, card, torch, np, own):
    """``python3 chip_smoke.py --k45-cells ROOT``: K45 alone, one call of its
    wrapper, in every cell that runs it (full_zoo and tet_lagrange8 at 1e5
    and 1e7 points, hdiv_hcurl_tet, sv_macro_tet and interval_zoo at 1e5;
    the main run's points and weights), on the fiat_tpu_torch package of the
    checkout at
    ROOT.  Prints {"k45_cells": {cell: [ms, device ms, DGEMV ms, bound ms,
    device ms / bound, resident warps an SM, host ms]}}: CUDA events, the
    profiler's device time of every kernel the call launches, one cuBLAS
    DGEMV of its stack built beforehand (this checkout's runs only; None for
    another's), the resident warps (None where the package does not report
    them) and the host's time to issue one call."""
    from fiat_tpu_torch import ufc_simplex
    from fiat_tpu_torch.ops import moments as mo
    from fiat_tpu_torch.ops.tabulate import BatchedTabulator

    T, T3 = ufc_simplex(2), ufc_simplex(3)
    lag8, hdiv = tet_zoos(T3)
    engines = {}

    def k45(name, make_zoo, sd, n):
        if name not in engines:
            engines[name] = mo.moment_engine(BatchedTabulator(make_zoo(), order=0,
                                                              device=dev)).moments
        pm = engines[name]
        big = n == BIG_NPTS
        P = torch.as_tensor(make_points(n, SEED + big, np, sd=sd), device=dev)
        wf = torch.as_tensor(np.random.default_rng(8 if big else 7).random(n), device=dev)

        def more(ev, dev_ms):
            lib = stack_mv_ms(pm, P, wf, torch, **({"reps": 5, "inner": 4} if big else {})) \
                if own else None
            bound = moments_bound(pm, n)[0]
            return [lib, bound, (dev_ms or ev) / bound, getattr(pm, "resident_warps", None),
                    host_ms(lambda: pm(P, wf), torch)]
        return lambda: pm(P, wf), more

    cells = {
        "full_zoo": lambda: k45("full_zoo", lambda: full_zoo(T), 2, NPTS),
        "full_zoo 1e7": lambda: k45("full_zoo", lambda: full_zoo(T), 2, BIG_NPTS),
        "tet_lagrange8": lambda: k45("tet_lagrange8", lambda: lag8, 3, NPTS),
        "tet_lagrange8 1e7": lambda: k45("tet_lagrange8", lambda: lag8, 3, BIG_NPTS),
        "hdiv_hcurl_tet": lambda: k45("hdiv_hcurl_tet", lambda: hdiv, 3, NPTS),
        "sv_macro_tet": lambda: k45("sv_macro_tet", lambda: sv_macro_tet(T3), 3, NPTS),
        "interval_zoo": lambda: k45("interval_zoo", lambda: families_zoo(
            INTERVAL_ZOO, (), ufc_simplex(1)), 1, NPTS)}
    time_cells("k45_cells", "one cuBLAS DGEMV on its stack ms; bound ms; device / bound; "
               "resident warps an SM; host ms a call", cells, card, torch, own)


def k6_cells(dev, card, torch, np, own):
    """``python3 chip_smoke.py --k6-cells ROOT``: K6 alone, one call of its
    wrapper, in every f32 cell (full_zoo, tet_lagrange8, hdiv_hcurl_tet,
    sv_macro_tet, interval_zoo at the main run's points), on the fiat_tpu_torch package of
    the checkout at ROOT.  Prints {"k6_cells": {cell: [ms, device ms, SGEMM
    ms, bound ms, device / bound, TB/s of out, FP32 peak share, host ms]}}:
    CUDA events, the profiler's device time of every kernel the call
    launches, one cuBLAS SGEMM (TF32 off) of the padded packed rows by a Phi
    computed beforehand (this checkout's runs only; None for another's), the
    bound, the rates at the device time and the host's time to issue one
    call.  On this checkout it also prints {"k6_plans": {cell: {plan: device
    ms}}}, the device time under every plan ``ZooF32Kernel.candidates``
    offers (the wrapper's own plan first), and {"k6_clocks": {cell: [SM
    MHz, W]}}, the card's clock and power draw while K6 runs back to back
    (the FP32 peak scales with the clock).  Also tet GLL Lagrange 20 (phase
    30: 1771 Phi rows, the wide mode, both its launches; a checkout that
    refuses it records the refusal), whose plans on this checkout are
    WIDE_PLANS, the wrapper's own first."""
    import fiat_tpu_torch as ft
    from fiat_tpu_torch import device_tabulator, ufc_simplex

    T, T3 = ufc_simplex(2), ufc_simplex(3)
    P = torch.as_tensor(make_points(NPTS, SEED, np), device=dev).float()
    P3 = torch.as_tensor(make_points(NPTS, SEED, np, sd=3), device=dev).float()
    P1 = torch.as_tensor(make_points(NPTS, SEED, np, sd=1), device=dev).float()
    lag8, hdiv = tet_zoos(T3)
    plans, clocks = {}, {}

    def k6(name, zoo, Q):
        tab = device_tabulator(zoo, order=1, f64=False, device=dev)
        k = tab.kernel
        out = torch.empty((k.total_rows, NPTS), device=dev)

        def run():
            return k(Q, tab.dst_plain, out)

        def more(ev, dev_ms):
            ms = dev_ms or ev
            bound = zoo_f32_bound(k, NPTS)[0]
            row = [zoo_f32_library_ms(k, Q, torch) if own else None, bound, ms / bound,
                   k.total_rows * NPTS * 4 / ms / 1e9,
                   zoo_f32_flops(k, NPTS) / ms / FP32_FMA_MS, host_ms(run, torch)]
            if own and k.mode == "wide":
                mine, plans[name] = (k.plan, k.group), {}
                for kc, stages, group in [(mine[0][1], mine[0][2], mine[1])] + [
                        p for p in WIDE_PLANS if p != (mine[0][1], mine[0][2], mine[1])]:
                    k.plan, k.group = (mine[0][0], kc, stages, mine[0][3]), group or mine[1]
                    plans[name][str((kc, stages, k.group))] = device_ms(run, torch)
                k.plan, k.group = mine
                clocks[name] = clock_under_load(run, torch)
            elif own:
                mine, plans[name] = k.plan, {}
                for plan in [mine] + [p for p in k.candidates(k.kpad) if p != mine]:
                    k.plan = plan
                    plans[name][str(plan)] = device_ms(run, torch)
                k.plan = mine
                clocks[name] = clock_under_load(run, torch)
            return row
        return run, more

    cells = {"full_zoo f32": lambda: k6("full_zoo f32", full_zoo(T), P),
             "tet_lagrange8 f32": lambda: k6("tet_lagrange8 f32", lag8, P3),
             "hdiv_hcurl_tet f32": lambda: k6("hdiv_hcurl_tet f32", hdiv, P3),
             "sv_macro_tet f32": lambda: k6("sv_macro_tet f32", sv_macro_tet(T3), P3),
             "interval_zoo f32": lambda: k6("interval_zoo f32", families_zoo(
                 INTERVAL_ZOO, (), ufc_simplex(1)), P1),
             "tet_gll20 f32": lambda: k6("tet_gll20 f32", [ft.Lagrange(T3, 20, variant="gll")],
                                         P3)}
    time_cells("k6_cells", "one cuBLAS SGEMM (TF32 off) on a computed Phi ms; bound ms; "
               "device / bound; TB/s of out and FP32 peak share at the device time; host ms "
               "a call", cells, card, torch, own)
    if own:
        print(json.dumps({"k6_plans": plans}))
        print(json.dumps({"k6_clocks": clocks}))


def k7_cells(dev, card, torch, np, own):
    """``python3 chip_smoke.py --k7-cells ROOT``: K7 alone, one call of its
    wrapper on a Phi computed beforehand, in every cell that runs it
    (sv_macro_tet's f64 tables; dg6_worsey_farin, past a block's shared
    memory; K3's merged triangle arrays of full_zoo and of the C1 zoo at
    order 1, 2 and 3), at the main run's points, on the fiat_tpu_torch
    package of the checkout at ROOT.  Prints {"k7_cells": {cell: [ms,
    device ms, DGEMM ms, bound ms, device / bound, TB/s of out, host ms]}}:
    CUDA events, the profiler's device time, one cuBLAS DGEMM of A by the
    masked B of the plain version (this checkout's runs only; None for
    another's), the bound, the output rate at the device time and the host's
    time to issue one call.  On this checkout it also prints {"k7_plans":
    {cell: {plan: [device ms, resident blocks an SM]}}}, the wrapper's own
    plan first, then every candidate up to twice the threads an SM its launch
    bounds assume."""
    import fiat_tpu_torch as ft
    from fiat_tpu_torch import device_tabulator, ufc_simplex
    from fiat_tpu_torch.ops.masked_matmul import MaskedMatmul

    T, T3 = ufc_simplex(2), ufc_simplex(3)
    P = torch.as_tensor(make_points(NPTS, SEED, np), device=dev)
    P3 = torch.as_tensor(make_points(NPTS, SEED, np, sd=3), device=dev)
    c1 = [ft.CubicHermite(T), ft.Morley(T), ft.Argyris(T, 5), ft.Bell(T),
          ft.HsiehCloughTocher(T, 3), ft.QuadraticPowellSabin6(T), ft.QuadraticPowellSabin12(T)]
    plans = {}

    def tables(zoo, Q):
        tab = device_tabulator(zoo, order=1, device=dev)
        return merged_macro(tab), tab.recurrence(Q), Q

    def k3_arrays(zoo, order, Q):
        tab = device_tabulator(zoo, order=order, device=dev)
        mo = merged_macro(tab)
        k7 = MaskedMatmul(mo.A.cpu().numpy(), list(enumerate(mo.nexp)), mo.geom, mo.parent_map,
                          device=dev)
        return k7, tab.recurrence(Q), Q

    def cell(name, make):
        def made():
            k7, phi, Q = make()

            def run():
                return k7(Q, phi)

            def more(ev, dev_ms):
                ms = dev_ms or ev
                bound = masked_bound(k7, NPTS)[0]
                lib = None
                if own:
                    B, A = k7.masked_basis(k7.masks(Q)[0], phi), k7.A.to(dev)
                    lib = median_ms(lambda: torch.matmul(A, B), torch)
                    del B, A
                    mine, plans[name] = k7.plan, {}
                    for plan in [mine] + [p for p in k7.candidates(k7.max_nexp, k7.chunk_cols,
                                                                   k7.sd, 2) if p != mine]:
                        k7.plan = plan
                        plans[name][str(plan)] = [device_ms(run, torch), k7.occupancy()]
                    k7.plan = mine
                return [lib, bound, ms / bound, k7.rows * NPTS * 8 / ms / 1e9, host_ms(run, torch)]
            return run, more
        return made

    cells = {"sv_macro_tet": lambda: tables(sv_macro_tet(T3), P3),
             "dg6_worsey_farin": lambda: tables(dg6_worsey_farin(T3), P3),
             "full_zoo K3 arrays": lambda: k3_arrays(full_zoo(T), 1, P),
             "c1_macro_zoo K3 arrays": lambda: k3_arrays(c1, 1, P),
             "c1_macro_hessians K3 arrays": lambda: k3_arrays(c1, 2, P),
             "c1_macro_zoo order 3 K3 arrays": lambda: k3_arrays(c1, 3, P)}
    time_cells("k7_cells", "one cuBLAS DGEMM on the masked B ms; bound ms; device / bound; "
               "TB/s of out at the device time; host ms a call",
               {name: cell(name, make) for name, make in cells.items()}, card, torch, own)
    if own:
        print(json.dumps({"k7_plans": plans}))


#: ``--k1-cells``' cells built from DubinerRecurrence alone (no zoo): (cell
#: name, sd, degree) at the main run's points.  The generic stage: interval
#: 30 is high_degree_interval's, triangle 20 ElementTabulator's GLL 20 and
#: high_degree_tri's, triangle 40 wide_tri's, tet 14 high_degree_tet's, tet
#: 20 wide_tet's and ElementTabulator's.  Under 0.01 ms: triangle 2 is
#: p2_tri_deg4rule's, triangle 3 split_variants_tri's, tet 1
#: split_variants_tet's degree.
K1_ALONE = (("interval 30 K1", 1, 30), ("triangle 20 K1", 2, 20), ("triangle 40 K1", 2, 40),
            ("tet 14 K1", 3, 14), ("tet 20 K1", 3, 20), ("triangle 2 K1", 2, 2),
            ("triangle 3 K1", 2, 3), ("tet 1 K1", 3, 1))


def k1_cells(dev, card, torch, np, own):
    """``python3 chip_smoke.py --k1-cells ROOT``: K1 alone, one call of its
    wrapper, on full_zoo, tet_lagrange8, hdiv_hcurl_tet, sv_macro_tet,
    families_tri, families_tet, interval_zoo and K1_ALONE, and K8 on the
    Bernstein routes of tet_lagrange8 and interval_bernstein, at the main
    run's points, on the fiat_tpu_torch package of the checkout at ROOT.
    Prints {"k1_cells": {cell: [ms, device ms, bound ms, device / bound,
    host ms, store ms]}}: CUDA events over back-to-back calls (the
    wrapper's host time included), the profiler's device time, the bound,
    the host's time to issue one call, and the card's own streaming store
    of the same output bytes (``fill_`` of a tensor of Phi's shape, events
    behind a spin: what the memory takes for this store, written in
    order).  On this checkout it also prints {"k1_plans": {cell: {(row
    groups, points a thread): ms}}}, K1's time (events behind a spin) under
    every plan on the triangle and the tetrahedron, the wrapper's own
    first."""
    from fiat_tpu_torch import device_tabulator, ufc_simplex
    from fiat_tpu_torch.core.expansions import ExpansionSet
    from fiat_tpu_torch.ops.fused_zoo import FusedZooTabulator
    from fiat_tpu_torch.ops.recurrence import DubinerRecurrence
    from fiat_tpu_torch.ops.tabulate import BatchedTabulator

    T, T3 = ufc_simplex(2), ufc_simplex(3)
    P = torch.as_tensor(make_points(NPTS, SEED, np), device=dev)
    P3 = torch.as_tensor(make_points(NPTS, SEED, np, sd=3), device=dev)
    P1 = torch.as_tensor(make_points(NPTS, SEED, np, sd=1), device=dev)
    pts = {1: P1, 2: P, 3: P3}
    lag8, hdiv = tet_zoos(T3)
    plans = {}

    def timed(name, fn, bound, Q, rows, sweep=False):
        def run():
            return fn(Q)

        def more(ev, dev_ms):
            out = torch.empty((rows, Q.shape[0]), dtype=torch.float64, device=dev)
            store = queued_ms(lambda: out.fill_(1.0), torch)
            del out
            if sweep:
                plans[name] = k1_plans(fn, run, torch)
            return [bound, (dev_ms or ev) / bound, host_ms(run, torch), store]
        return run, more

    def k1(name, rec, Q):
        return timed(name, rec, rec_bound(rec, NPTS)[0], Q, rec.nexp, own and rec.sd > 1)

    def alone(name, sd, degree):
        es = ExpansionSet(ufc_simplex(sd))
        return k1(name, DubinerRecurrence(sd, degree, float(es.get_scale(degree)),
                                          es.affine_mappings[0], device=dev), pts[sd])

    def k8(name, zoo, Q):
        feat = FusedZooTabulator(BatchedTabulator(zoo, order=1, device="cpu"), device=dev,
                                 features="bernstein").features
        return timed(name, feat, features_bound(feat, NPTS)[0], Q, feat.nexp)

    zoos = {"full_zoo K1": (lambda: full_zoo(T), P),
            "tet_lagrange8 K1": (lambda: lag8, P3),
            "hdiv_hcurl_tet K1": (lambda: hdiv, P3),
            "sv_macro_tet K1": (lambda: sv_macro_tet(T3), P3),
            "families_tri K1": (lambda: families_zoo(FAMILIES_TRI, COMPOSITES_TRI, T), P),
            "families_tet K1": (lambda: families_zoo(FAMILIES_TET, COMPOSITES_TET, T3), P3),
            "interval_zoo K1": (lambda: families_zoo(INTERVAL_ZOO, (), ufc_simplex(1)), P1)}
    cells = {name: lambda name=name, make=make, Q=Q: k1(
        name, device_tabulator(make(), order=1, device=dev).recurrence, Q)
             for name, (make, Q) in zoos.items()}
    cells.update({name: lambda name=name, sd=sd, n=n: alone(name, sd, n)
                  for name, sd, n in K1_ALONE})
    cells["tet_lagrange8 K8"] = lambda: k8("tet_lagrange8 K8", lag8, P3)
    cells["interval_bernstein K8"] = lambda: k8("interval_bernstein K8", families_zoo(
        INTERVAL_BERNSTEIN, (), ufc_simplex(1)), P1)
    time_cells("k1_cells", "bound ms; device / bound; host ms a call; the card's fill_ of "
               "the same bytes ms", cells, card, torch, own)
    if own:
        print(json.dumps({"k1_plans": plans}))


def k1_plans(rec, run, torch):
    """{str((row groups, points a thread)): ms} of K1
    under every plan it takes at the main run's points
    (ops/recurrence.py ``plans``), the wrapper's own first; CUDA events
    behind a spin."""
    from fiat_tpu_torch.ops.recurrence import plans
    mine = rec.plan_for(NPTS)
    out = {}
    for plan in [mine] + [p for p in plans(rec.degree, NPTS) if p != mine]:
        rec.plan = plan
        out[str(plan)] = queued_ms(run, torch)
    rec.plan = None
    resident = {str((g, v)): rec.resident_blocks(g, v) for g in (False, True) for v in (1, 2)}
    print(f"K1 sd {rec.sd} degree {rec.degree} plans ((row groups, points a thread): ms "
          f"queued behind a spin; the wrapper's first): {out}; blocks resident on the card "
          f"by (grouped, points a thread): {resident}")
    return out


# -- phases 22-25: the rest of core, the per-program route, jets, sharding ------------

#: phase 22: Grundmann-Moller degrees and their bars (tests/test_quadrature.py:
#: 111-155): absolute to degree 11, relative on the first eight monomials of
#: the top degree past it
GM_DEGREES = (1, 2, 3, 5, 8, 11)
GM_HIGH_DEGREES = (21, 25)
GM_ATOL, GM_HIGH_RTOL = 1e-12, 5e-12
#: phase 22: a functional's reading on a card-tabulated element against host
#: el.tabulate, relative to max(1, max |reading|)
FUNCTIONAL_RTOL = 1e-10
#: phase 25: a sharded step against the unsharded engine on the card, relative
#: to max(1, max |unsharded|): the per-point steps are the same kernels on a
#: part of the points; the moments sum in another order
SHARDED_RTOL = {"tabulate": KERNEL_RTOL, "fused": KERNEL_RTOL, "interpolation": KERNEL_RTOL,
                "moments": 1e-12, "moments_2d": 1e-12, "moments_2d_points": 1e-12}
SHARD_REPS = 5
WORLD_TIMEOUT_S = 400


def gm_phase(torch, np, dev):
    """Phase 22, first half: the "gm" rules on the UFC simplices of
    dimension 1-3 integrate every monomial to their degree, summed on the
    card in float64, against the exact integrals prod(a_i!) / (|a| + sd)!."""
    from itertools import product
    from fiat_tpu_torch import create_quadrature, ufc_simplex

    worst = {}
    for sd in (1, 2, 3):
        for degree in GM_DEGREES + GM_HIGH_DEGREES:
            Q = create_quadrature(ufc_simplex(sd), degree, "gm")
            X = torch.as_tensor(Q.get_points(), device=dev).reshape(-1, sd)
            W = torch.as_tensor(Q.get_weights(), device=dev)
            high = degree in GM_HIGH_DEGREES
            alphas = [a for a in product(range(degree + 1), repeat=sd)
                      if (sum(a) == degree if high else sum(a) <= degree)]
            if high:                   # the first eight top monomials, as the tests
                alphas = alphas[:8]
            A = torch.as_tensor(alphas, dtype=torch.float64, device=dev)
            vals = (X[:, None, :] ** A[None]).prod(dim=2).T @ W
            exact = torch.as_tensor([math.prod(math.factorial(k) for k in a)
                                     / math.factorial(sum(a) + sd) for a in alphas],
                                    dtype=torch.float64, device=dev)
            err = ((vals - exact).abs() / (exact if high else 1.0)).max().item()
            worst[(sd, degree)] = err
            if not err <= (GM_HIGH_RTOL if high else GM_ATOL):
                fail(f"gm rule sd {sd} degree {degree}: {err:.3e} from the exact integrals")
    print(f"rest_of_core gm rules on the card: sd 1-3, degrees {GM_DEGREES} (absolute, limit "
          f"{GM_ATOL}) and {GM_HIGH_DEGREES} (relative, limit {GM_HIGH_RTOL}); worst "
          + ", ".join(f"sd {sd} deg {d} {e:.2e}" for (sd, d), e in worst.items()
                      if d in (11, 25)))


def new_functionals(ft, fn, sd):
    """The fourteen functional classes of the rest of core, on the UFC
    simplex of dimension ``sd`` where they are defined there (the face
    tangent moment on the tetrahedron, the rest on the triangle)."""
    import numpy as np
    from fiat_tpu_torch.core.quadrature_schemes import create_quadrature
    K = ft.ufc_simplex(sd)
    pt = tuple(np.linspace(0.15, 0.3, sd))
    Qe = create_quadrature(ft.ufc_simplex(sd - 1), 6)
    xe = Qe.get_points().reshape(len(Qe.get_weights()), -1).sum(axis=1)
    if sd == 3:
        return [fn.IntegralMomentOfFaceTangentEvaluation(
            K, Qe, np.stack([1.0 + xe, xe ** 2, 1.0 - 2.0 * xe]), 2)]
    Q = create_quadrature(K, 5)
    x = Q.get_points().sum(axis=1)
    return [fn.PointNormalEvaluation(K, 1, pt), fn.PointTangentialDerivative(K, 0, pt),
            fn.PointSecondDerivative(K, (0.6, 1.1), (-1.0, 0.4), pt),
            fn.PointNormalSecondDerivative(K, 2, pt),
            fn.PointTangentialSecondDerivative(K, 1, pt),
            fn.IntegralMomentOfDivergence(K, Q, 1.0 + x ** 2),
            fn.IntegralMomentOfNormalEvaluation(K, Qe, 1.0 + 2.0 * xe, 1),
            fn.IntegralMomentOfScaledNormalEvaluation(K, Qe, 1.0 - xe, 2),
            fn.IntegralMomentOfTangentialEvaluation(K, Qe, xe ** 2, 0),
            fn.IntegralMomentOfEdgeTangentEvaluation(K, Qe, 1.0 + xe, 1),
            fn.IntegralLegendreNormalMoment(K, 0, 2, 6),
            fn.IntegralLegendreTangentialMoment(K, 1, 3, 7),
            fn.IntegralLegendreTangentialTangentialMoment(K, 2, 1, 5)]


def readings(ells, per_elem, offsets, value_shapes, np, xp=None):
    """ell(phi_i) for every functional and element of matching value
    shape, from per-element tables {alpha: (ndof, *shape, npts)} at the
    functionals' points stacked (``offsets``): {(functional, element):
    (ndof,) array}."""
    out = {}
    for f, (ell, off) in enumerate(zip(ells, offsets)):
        for e, (tabs, shape) in enumerate(zip(per_elem, value_shapes)):
            if tuple(shape) != tuple(ell.target_shape):
                continue
            acc = 0.0
            for k in range(len(ell.weights)):
                tab = tabs[tuple(int(a) for a in ell.alphas[k])]
                tab = tab.reshape(tab.shape[0], -1, tab.shape[-1])
                acc = acc + float(ell.weights[k]) * tab[:, int(ell.comps[k]),
                                                        off + int(ell.pt_ids[k])]
            out[(f, e)] = acc if xp is None else acc.cpu().numpy()
    return out


def rest_of_core_phase(dev, card, torch, np):
    """Phase 22: the gm rules against exact monomial integrals on the card;
    the fourteen functionals of the rest of core read on ``full_zoo``
    (with Regge 2 and HHJ 1 for the tensor-valued one) tabulated on the
    card at order 2 (K1 + K2 + K3), and the face tangent moment on
    ``hdiv_hcurl_tet`` (K1 + K2 at sd = 3), against host el.tabulate."""
    import fiat_tpu_torch as ft
    from fiat_tpu_torch import device_tabulator
    from fiat_tpu_torch.core import functionals as fn

    gm_phase(torch, np, dev)
    T, S = ft.ufc_simplex(2), ft.ufc_simplex(3)
    cases = [("full_zoo", full_zoo(T) + [ft.Regge(T, 2), ft.HellanHerrmannJohnson(T, 1)],
              new_functionals(ft, fn, 2)),
             ("hdiv_hcurl_tet", tet_zoos(S)[1], new_functionals(ft, fn, 3))]
    classes, count, worst = set(), 0, 0.0
    for name, zoo, ells in cases:
        offsets = np.cumsum([0] + [len(e.points) for e in ells])[:-1]
        X = np.vstack([e.points for e in ells])
        tab = device_tabulator(zoo, order=2)          # the card
        engines = {"K1": tab.recurrence, "K2": tab.matmul}
        if merged_macro(tab) is not None:
            engines[merged_macro(tab).name] = merged_macro(tab)
        blocks, launches = counted(engines, lambda: tab.block_tables(X), torch)
        expect_launches(f"rest_of_core {name}", launches, dict.fromkeys(engines, 1))
        shapes = [el.value_shape() for el in zoo]
        card_r = readings(ells, tab.unpack(blocks), offsets, shapes, np, xp=torch)
        host = [el.tabulate(2, X) for el in zoo]
        host_r = readings(ells, host, offsets, shapes, np)
        for key, want in host_r.items():
            err = float(np.abs(card_r[key] - want).max()) / max(1.0, float(np.abs(want).max()))
            worst = max(worst, err)
            if not err <= FUNCTIONAL_RTOL:
                fail(f"rest_of_core: {type(ells[key[0]]).__name__} on "
                     f"{type(zoo[key[1]]).__name__}: {err:.3e} from host")
        classes |= {type(ells[f]).__name__ for f, _ in host_r}
        count += len(host_r)
    if len(classes) != 14:
        fail(f"rest_of_core: {len(classes)} of the 14 functionals read on an element")
    print(f"rest_of_core functionals: the 14 classes, {count} (functional, element) readings on "
          f"the card's order-2 tables of full_zoo + Regge 2 + HHJ 1 and hdiv_hcurl_tet, against "
          f"host el.tabulate: worst {worst:.3e} of max(1, max |reading|) (limit "
          f"{FUNCTIONAL_RTOL})")


def edited_state(state, edits, np):
    """``state`` with macro programs moved to other parent bases as the
    tests move them (``rebase_program``): ``edits`` {program: (attribute,
    value)} of the parent's expansion set (a variant, another cell map,
    another scale); the tables stay the elements'."""
    import copy
    from fiat_tpu_torch.ops.tabulate import rebase_program
    programs = list(state["macro_programs"])
    for g, (attr, value) in edits.items():
        pes = copy.copy(programs[g].parent_es)
        setattr(pes, attr, value)
        programs[g] = rebase_program(programs[g], pes)
    return {**state, "macro_programs": programs}


def rotated_map(ft, sd, np):
    """The UFC simplex onto the reference simplex with its vertices
    rotated: another Dubiner basis of the same polynomials."""
    from fiat_tpu_torch.core.cells import make_affine_mapping
    return [make_affine_mapping(np.roll(ft.ufc_simplex(sd).get_vertices(), 1, axis=0),
                                ft.default_simplex(sd).get_vertices())]


def route_entries(label, fz, P, basis, card, torch, routes, launches):
    """Each macro route in ``routes`` against its plain version on the card,
    timed beside it and its library call; ``launches`` the main path's
    counts (``counted``, by "<kernel> route <k>"); returns kernels-line
    entries."""
    from fiat_tpu_torch.ops.fused_zoo import masked_parent
    src = "fiat_tpu_torch/csrc/"
    out = []
    for k in routes:
        r = fz.macro_routes[k]
        rows = r.engine.total_rows if r.name == "K2" else r.engine.rows
        err = check_kernel(f"{label} route {k} {r.name} ({rows} rows, programs {r.members})",
                           r(P, basis), r.plain(P, basis), torch)
        ms = median_ms(lambda: r(P, basis), torch)
        pl = plain_ms(lambda: r.plain(P, basis), torch)
        if r.name == "K3":
            bound, lib = macro_bound(r.engine, NPTS), masked_gemm_ms(r.engine, P, torch)
            out.append(entry(f"K3 macro_oneshot ({label}, route {k})", src + "macro_oneshot.cu",
                             "fiat_tpu/ops/pallas_multiword.py:652", launches[f"K3 route {k}"],
                             err, ms, pl, bound, lib))
        elif r.name == "K7":
            phi = basis if r.recurrence is None else r.recurrence(P)
            B, A = r.engine.masked_basis(r.engine.masks(P)[0], phi), r.engine.A.to(P.device)
            lib = median_ms(lambda: torch.matmul(A, B), torch)
            del B, A
            out.append(entry(f"K7 masked_matmul ({label}, route {k})", src + "masked_matmul.cu",
                             "fiat_tpu/ops/pallas_multiword.py:440", launches[f"K7 route {k}"],
                             err, ms, pl, masked_bound(r.engine, NPTS), lib))
        else:
            B = masked_parent(r.program, P, r.unique).contiguous()
            A = r.engine.A.to(P.device)
            lib = median_ms(lambda: torch.matmul(A, B), torch)
            k2 = median_ms(lambda: r.engine(B), torch)
            del A, B
            out.append(entry(f"K2 bucket_matmul ({label}, route {k}, variant parent)",
                             src + "bucket_matmul.cu", "fiat_tpu/ops/pallas_multiword.py:269",
                             launches[f"K2 route {k}"], err, k2, pl,
                             matmul_bound(r.engine, NPTS), lib))
            print(f"{label} route {k} K2 alone on the masked parent {k2:.4f} ms; the route with "
                  f"its PyTorch masked parent {ms:.4f} ms")
        print(f"{label} route {k} {r.name} timing ({card}): {ms:.4f} ms (plain {pl:.4f}, "
              f"library {out[-1]['library_ms']:.4f}, bound {out[-1]['bound_ms']:.4f} by "
              f"{out[-1]['bound_by']})")
    return out


def per_program_phase(dev, card, torch, np):
    """Phase 23: the per-program macro route (fiat_tpu's macro_fms, by
    group) at 1e5 points on full_zoo's macro programs with a parent moved
    to another basis as the tests move it, on sv_macro_tet's, and on the
    zoos of DG 0 beside Lagrange 2 on the Alfeld and Worsey-Farin splits,
    which reach the route unedited: f64 tables (K3 a group, K2 on a
    variant parent; K7 a group on the tet, one with its own K1), moments
    (K45 a group), interpolation (K3 a group), f32 tables (K3 float32 a
    group); every kernel against its plain version, launches asserted,
    tables and moments held to host."""
    import fiat_tpu_torch as ft
    from fiat_tpu_torch.ops.f32_zoo import F32ZooTabulator
    from fiat_tpu_torch.ops.fused_zoo import FusedZooTabulator
    from fiat_tpu_torch.ops.moments import MomentEngine
    from fiat_tpu_torch.ops.tabulate import BatchedTabulator

    T, S = ft.ufc_simplex(2), ft.ufc_simplex(3)
    pts2, pts3 = make_points(NPTS, SEED, np), make_points(NPTS, SEED, np, sd=3)
    P2, P3 = (torch.as_tensor(p, device=dev) for p in (pts2, pts3))
    zoo = full_zoo(T)
    bt1 = BatchedTabulator(zoo, order=1, device="cpu")
    bt0 = BatchedTabulator(zoo, order=0, device="cpu")
    # (label, zoo, tabulator, points, edits, routes, routes reported)
    configs = [("full_zoo scale", zoo, bt1, pts2, P2,
                {1: ("get_scale", lambda n, cell=0: 0.5)}, ["K3", "K3"], [1]),
               ("full_zoo variant", zoo, bt1, pts2, P2, {0: ("variant", "dual")},
                ["K3", "K2"], [1])]
    sv = sv_macro_tet(S)
    configs.append(("sv_macro_tet cell map", sv, BatchedTabulator(sv, order=1, device="cpu"),
                    pts3, P3, {3: ("affine_mappings", rotated_map(ft, 3, np))}, ["K7", "K7"],
                    [0, 1]))
    # zoos of the families that reach the route unedited: DG 0 beside a
    # macro element (the zoo's degree-0 basis has scale 1, the parent not)
    for K, variant, route, pts, P in ((T, "alfeld", "K3", pts2, P2),
                                      (S, "worsey-farin", "K7", pts3, P3)):
        z = [ft.DiscontinuousLagrange(K, 0), ft.Lagrange(K, 2, variant=variant)]
        configs.append((f"dg0 + Lagrange 2 {variant}", z,
                        BatchedTabulator(z, order=1, device="cpu"), pts, P, {}, [route], [0]))
    entries, ref64 = [], None
    for label, z, bt, pts, P, edits, names, report in configs:
        st = edited_state(bt.state(), edits, np)
        fz = FusedZooTabulator.from_arrays(**st, device=dev)
        if [r.name for r in fz.macro_routes] != names:
            fail(f"{label}: routes {[r.name for r in fz.macro_routes]}, expected {names}")
        print(f"per_program_macro {label}: routes "
              + "; ".join(f"{r.name} on programs {r.members}"
                          + (" with its own K1" if r.recurrence is not None else "")
                          for r in fz.macro_routes))
        engines = {"K1": fz.recurrence, "K2": fz.matmul}
        for k, r in enumerate(fz.macro_routes):
            engines.update({f"{n} route {k}": e for n, e in r.kernels().items()})
        blocks, launches = counted(engines, lambda: fz.block_tables(P), torch)
        expect_launches(f"per_program_macro {label} f64", launches, dict.fromkeys(engines, 1))
        host_err = host_check(z, fz.unpack(blocks), pts, NPTS, torch, np)
        print(f"per_program_macro {label} f64 vs host el.tabulate on {HOST_CHECK_PTS} points: "
              f"{host_err:.3e}")
        if not host_err <= HOST_ATOL:
            fail(f"{label}: {host_err:.3e} from host > {HOST_ATOL}")
        if label == "full_zoo scale":
            ref64 = {a: torch.cat([fz._table(i, t) for i in sorted(
                range(len(fz.slices)), key=lambda i: fz.slices[i][0])]) for a, t in blocks.items()}
        del blocks
        basis = fz.recurrence(P)
        entries += route_entries(f"per_program_macro {label}", fz, P, basis, card, torch,
                                 report, launches)
        del basis
        torch.cuda.empty_cache()

    # moments and interpolation on the edited programs (order 0)
    wf_h = np.random.default_rng(7).random(NPTS)
    wf = torch.as_tensor(wf_h, device=dev)
    dg0 = [ft.DiscontinuousLagrange(T, 0), ft.Lagrange(T, 2, variant="alfeld")]
    for label, z, b0, edits, counts in (
            ("full_zoo scale", zoo, bt0, {1: ("get_scale", lambda n, cell=0: 0.5)}, (2, 2)),
            ("full_zoo variant", zoo, bt0, {0: ("variant", "dual")}, (1, 1)),
            ("dg0 + Lagrange 2 alfeld", dg0, BatchedTabulator(dg0, order=0, device="cpu"), {},
             (2, 1))):
        eng = MomentEngine.from_arrays(**edited_state(b0.state(), edits, np), device=dev)
        pms, k3s = eng.moment_kernels, eng.macros
        if (len(pms), len(k3s)) != counts:
            fail(f"{label}: {len(pms)} K45 and {len(k3s)} K3, expected {counts}")
        c = torch.as_tensor(np.random.default_rng(11).random(eng.rows) - 0.5, device=dev)
        engines = {f"K45 {k}": pm for k, pm in enumerate(pms)}
        engines.update({f"K3 {k}": m for k, m in enumerate(k3s)})
        engines["K1"] = eng.recurrence
        M, launches = counted(engines, lambda: eng.moment_rows(P2, wf), torch)
        expect_launches(f"per_program_macro {label} moments", launches,
                        {k: int(k.startswith("K45")) for k in engines})
        k45_launches = launches
        u, launches = counted(engines, lambda: eng.interpolate_rows(P2, c), torch)
        expect_launches(f"per_program_macro {label} interpolation", launches,
                        {k: int(not k.startswith("K45")) for k in engines})
        n = HOST_CHECK_PTS
        Mh = eng.moment_rows(P2[:n], wf[:n]).cpu().numpy()
        c_h = c.cpu().numpy()
        mom_err, host_u = 0.0, np.zeros(n)
        for el, (lo, hi, _) in zip(z, b0.slices):
            tab = np.asarray(el.tabulate(0, pts2[:n])[(0, 0)]).reshape(hi - lo, n)
            mom_err = max(mom_err, float(np.abs(tab @ wf_h[:n] - Mh[lo:hi]).max()))
            host_u += c_h[lo:hi] @ tab
        u_err = float(np.abs(u[:n].cpu().numpy() - host_u).max())
        print(f"per_program_macro {label} vs host on {n} points: moments {mom_err:.3e}, "
              f"interpolation {u_err:.3e}")
        if not (mom_err <= HOST_ATOL and u_err <= HOST_ATOL):
            fail(f"{label}: moments {mom_err:.3e} / interpolation {u_err:.3e} > {HOST_ATOL}")
        for k, pm in enumerate(pms[1:], 1):
            err = check_kernel(f"per_program_macro {label} K45 {k} ({pm.rows} sums)",
                               pm(P2, wf), pm.plain(P2, wf), torch)
            ms, pl = median_ms(lambda: pm(P2, wf), torch), plain_ms(lambda: pm.plain(P2, wf),
                                                                     torch)
            lib = stack_mv_ms(pm, P2, wf, torch)
            entries.append(entry(f"K45 pair_moments (per_program_macro {label}, group {k})",
                                 "fiat_tpu_torch/csrc/moments.cu",
                                 "fiat_tpu/ops/pallas_recurrence.py:549, "
                                 "fiat_tpu/ops/pallas_recurrence.py:727",
                                 k45_launches[f"K45 {k}"], err, ms, pl,
                                 moments_bound(pm, NPTS), lib))
            print(f"per_program_macro {label} K45 {k} timing ({card}): {ms:.4f} ms (plain "
                  f"{pl:.4f}, one DGEMV on its stack {lib:.4f})")
        del eng, M, u
        torch.cuda.empty_cache()

    # f32 tables on the groups (K6 + K3 float32 a group), held to the f64 ones
    st = edited_state(bt1.state(), {1: ("get_scale", lambda n, cell=0: 0.5)}, np)
    tab32 = F32ZooTabulator.from_arrays(**st, device=dev)
    engines = {"K6": tab32.kernel}
    engines.update({f"K3 float32 route {k}": e for k, e in enumerate(tab32.macro_routes)})
    tables, launches = counted(engines, lambda: tab32.tables(P2), torch)
    expect_launches("per_program_macro full_zoo scale f32", launches, dict.fromkeys(engines, 1))
    f32_vs_f64("per_program_macro full_zoo scale f32", tab32, zoo, tables, ref64, torch)
    del tables, ref64
    k3 = tab32.macro_routes[1]
    P32 = P2.float()
    err = check_kernel("per_program_macro full_zoo scale K3 float32 route 1", k3(P32),
                       k3.plain(P32), torch, rtol=F32_KERNEL_RTOL)
    ms, pl = median_ms(lambda: k3(P32), torch), plain_ms(lambda: k3.plain(P32), torch)
    entries.append(entry("K3 macro_oneshot float32 (per_program_macro full_zoo scale, route 1)",
                         "fiat_tpu_torch/csrc/macro_oneshot_f32.cu",
                         "fiat_tpu/ops/pallas_multiword.py:652",
                         launches["K3 float32 route 1"], err, ms, pl,
                         macro_bound(k3, NPTS, itemsize=4, flops_ms=FP32_FMA_MS),
                         masked_gemm_ms(k3, P32, torch)))
    print(f"per_program_macro full_zoo scale K3 float32 route 1 timing ({card}): {ms:.4f} ms "
          f"(plain {pl:.4f})")
    torch.cuda.empty_cache()
    return entries


def jets_phase(dev, card, torch, np):
    """Phase 24: ``device_tabulator(full_zoo, order=1, derivs="jets")``:
    fiat_tpu's engines key only the value table under jets, so the pass is
    K1 + K2 (+ K3 for the macro elements' values) on the values alone, each
    kernel against its plain version, the values held to host and to the
    dmats engine's."""
    import fiat_tpu_torch as ft
    from fiat_tpu_torch import device_tabulator

    pts = make_points(NPTS, SEED, np)
    P = torch.as_tensor(pts, device=dev)
    zoo = full_zoo(ft.ufc_simplex(2))
    tab = device_tabulator(zoo, order=1, derivs="jets")
    rec, mm, mo = tab.recurrence, tab.matmul, merged_macro(tab)
    if tab.alphas != [(0, 0)]:
        fail(f"jets: the engine keys {tab.alphas}, fiat_tpu's the value table alone")
    phi_p = rec.plain(P)
    k1_err = check_kernel("jets K1 recurrence", rec(P), phi_p, torch)
    k2_err = check_kernel(f"jets K2 bucket matmul ({mm.total_rows} x {NPTS})", mm(phi_p),
                          mm.plain(phi_p), torch)
    del phi_p
    check_kernel(f"jets {mo.name} ({mo.rows} rows)", mo(P), mo.plain(P), torch)
    engines = {"K1": rec, "K2": mm, mo.name: mo}
    blocks, launches = counted(engines, lambda: tab.block_tables(P), torch)
    expect_launches("jets", launches, dict.fromkeys(engines, 1))
    if set(blocks) != {(0, 0)}:
        fail(f"jets: keys {sorted(blocks)}")
    host_err = host_check(zoo, tab.unpack(blocks), pts, NPTS, torch, np, order=0)
    dm = device_tabulator(zoo, order=1)
    ref = dm.block_tables(P)[(0, 0)]
    dm_err = max(rel_err(a, b)[1] for a, b in zip(blocks[(0, 0)], ref))
    del ref, dm
    print(f"jets main path: device_tabulator(full_zoo, order=1, derivs='jets').block_tables: "
          f"keys {sorted(blocks)} (fiat_tpu's), max abs err vs host el.tabulate(0) on "
          f"{HOST_CHECK_PTS} points {host_err:.3e}, vs the dmats engine's values {dm_err:.3e}")
    if not (host_err <= HOST_ATOL and dm_err <= KERNEL_RTOL):
        fail(f"jets: {host_err:.3e} from host or {dm_err:.3e} from the dmats values")
    del blocks
    phi = rec(P)
    k1_ms, k1_pl = median_ms(lambda: rec(P), torch), plain_ms(lambda: rec.plain(P), torch)
    k2_ms, k2_pl = median_ms(lambda: mm(phi), torch), plain_ms(lambda: mm.plain(phi), torch)
    A = mm.A.to(dev)
    k2_lib = median_ms(lambda: torch.matmul(A, phi[:mm.max_k]), torch)
    del A, phi
    path = median_ms(lambda: tab.block_tables(P), torch)
    print(f"jets timing ({card}): pass {path:.4f} ms, K1 {k1_ms:.4f} (plain {k1_pl:.4f}), K2 "
          f"{k2_ms:.4f} (plain {k2_pl:.4f}, one padded DGEMM {k2_lib:.4f})")
    src = "fiat_tpu_torch/csrc/"
    return [entry("K1 dubiner2_values (full_zoo jets)", src + "recurrence.cu",
                  "fiat_tpu/ops/pallas_recurrence.py:399", launches["K1"], k1_err, k1_ms, k1_pl,
                  rec_bound(rec, NPTS)),
            entry("K2 bucket_matmul (full_zoo jets)", src + "bucket_matmul.cu",
                  "fiat_tpu/ops/pallas_multiword.py:269", launches["K2"], k2_err, k2_ms, k2_pl,
                  matmul_bound(mm, NPTS), k2_lib)]


def host_timed(fn, torch, reps=SHARD_REPS):
    """Median host-clock ms of fn(), the card synchronized around each."""
    times = []
    for _ in range(reps + 1):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times[1:])


def sharded_rank(rank, n, backend):
    """One rank of phase 25: full_zoo at 1e5 points through every step of
    ``fiat_tpu_torch.parallel.sharding`` on the card, each step's kernels
    counted, its time (host clock, the card synchronized) and its
    collective's, and each held against the unsharded engine on the card.
    Returns {"launches", "ms", "collective_ms", "err", "k45", "k2"}."""
    import numpy as np
    import torch
    import fiat_tpu_torch as ft
    from fiat_tpu_torch import device_tabulator
    from fiat_tpu_torch.ops.moments import moment_engine
    from fiat_tpu_torch.ops.tabulate import BatchedTabulator
    from fiat_tpu_torch.parallel import sharding as sh

    dev = torch.device("cuda", torch.cuda.current_device())
    zoo = full_zoo(ft.ufc_simplex(2))
    pts = make_points(NPTS, SEED, np)
    P = torch.as_tensor(pts, device=dev)
    w = torch.as_tensor(np.random.default_rng(7).random(NPTS), device=dev)
    f = torch.ones(NPTS, dtype=torch.float64, device=dev)
    bt = BatchedTabulator(zoo, order=0, device=dev)
    eng = moment_engine(bt)
    fz0 = device_tabulator(zoo, order=0, device=dev)
    fz = device_tabulator(zoo, order=1, device=dev)
    c = torch.as_tensor(np.random.default_rng(11).random(eng.rows) - 0.5, device=dev)
    mesh = sh.points_mesh(n)
    mesh2 = sh.zoo_mesh(n // 2 or 1, 2 if n > 1 else 1)
    first, end = sh.shard_bounds(NPTS, mesh)
    p, ws, fs = (sh.shard_points(a, mesh) for a in (P, w, f))
    p2, w2, f2 = (sh.shard_points(a, mesh2) for a in (P, w, f))
    moment = sh.make_moment_step(bt, mesh)
    moment2 = sh.make_moment_step_2d(bt, mesh2)
    # past one rank, the 2-D step also on a (points n, rows 1) mesh: its
    # all-reduce crosses ranks
    mesh3 = sh.zoo_mesh(n, 1) if n > 1 else None
    moment3 = sh.make_moment_step_2d(bt, mesh3) if mesh3 else None
    interp = sh.make_interpolation_step(bt, mesh)
    fused = sh.make_fused_tabulate_step(fz, mesh)
    mo0, mo = merged_macro(fz0), merged_macro(fz)
    kernels = {"tabulate": {"K1": fz0.recurrence, "K2": fz0.matmul, mo0.name: mo0},
               "fused": {"K1": fz.recurrence, "K2": fz.matmul, mo.name: mo},
               "moments": {"K45": eng.moments}, "moments_2d": {"K45": eng.moments},
               "moments_2d_points": {"K45": eng.moments},
               "interpolation": {"K1": eng.recurrence, "K3": merged_macro(eng)}}
    steps = {"tabulate": lambda: sh.sharded_tabulate(fz0, P, mesh),
             "fused": lambda: fused(p), "moments": lambda: moment(p, ws, fs),
             "moments_2d": lambda: moment2(p2, w2, f2), "interpolation": lambda: interp(p, c)}
    if moment3 is not None:
        steps["moments_2d_points"] = lambda: moment3(p, ws, fs)
    out = {"launches": {}, "ms": {}, "collective_ms": {}, "err": {}}
    got = {}
    for name, run in steps.items():
        for k in kernels[name].values():
            k.launches = 0
        got[name] = run()
        torch.cuda.synchronize()
        out["launches"][name] = {k: v.launches for k, v in kernels[name].items()}
        step = {"moments": moment, "moments_2d": moment2, "moments_2d_points": moment3}.get(name)
        colls = []

        def timed_run(run=run, step=step):
            run()
            if step is not None:
                colls.append(step.collective_ms)
        out["ms"][name] = host_timed(timed_run, torch)
        if step is not None:
            out["collective_ms"][name] = statistics.median(colls[1:])

    def rel(a, b):
        return (a - b).abs().max().item() / max(1.0, b.abs().max().item())

    ref = fz0(P)[(0, 0)]
    out["err"]["tabulate"] = rel(got["tabulate"][(0, 0)], ref[:, first:end])
    del ref, got["tabulate"]
    whole = fz.block_tables(P)
    out["err"]["fused"] = max(rel(a, b[:, first:end]) for al in whole
                              for a, b in zip(got["fused"][al], whole[al]))
    del whole, got["fused"]
    torch.cuda.empty_cache()
    wf = w * f
    M = eng.moment_rows(P, wf)
    out["err"]["moments"] = rel(got["moments"], M)
    rows2 = sh.gather(got["moments_2d"], mesh2, axis="rows", dim=0)[:eng.rows]
    out["err"]["moments_2d"] = rel(rows2, M)
    if moment3 is not None:
        out["err"]["moments_2d_points"] = rel(got["moments_2d_points"][:eng.rows], M)
    out["err"]["interpolation"] = rel(got["interpolation"], eng.interpolate_rows(P, c)[first:end])
    # rank 0's K45 and K2 on its shard, for the kernels line
    pm, mm = eng.moments, fz.matmul
    k45_err = (pm(p, ws) - pm.plain(p, ws)).abs().max().item()
    phi = fz.recurrence(p)
    k2_err = (mm(phi) - mm.plain(phi)).abs().max().item()
    A = mm.A.to(dev)
    out["k45"] = [k45_err, median_ms(lambda: pm(p, ws), torch),
                  plain_ms(lambda: pm.plain(p, ws), torch), list(moments_bound(pm, p.shape[0])),
                  stack_mv_ms(pm, p, ws, torch)]
    out["k2"] = [k2_err, median_ms(lambda: mm(phi), torch), plain_ms(lambda: mm.plain(phi), torch),
                 list(matmul_bound(mm, p.shape[0])),
                 median_ms(lambda: torch.matmul(A, phi[:mm.max_k]), torch)]
    out["shard"] = [first, end]
    return out


def sharded_phase(dev, card, torch, np):
    """Phase 25: full_zoo at 1e5 points through every sharded step, in a
    world of one process on NCCL and in a world of two processes on gloo
    on the one card (NCCL refuses two ranks on one device), each rank's
    kernels counted, every step held to the unsharded engine on the card,
    each step's time and its collective's share printed."""
    from fiat_tpu_torch.parallel.sharding import spawn_world

    entries = []
    want = {"tabulate": {"K1": 1, "K2": 1, "K3": 1}, "fused": {"K1": 1, "K2": 1, "K3": 1},
            "moments": {"K45": 1}, "moments_2d": {"K45": 1}, "moments_2d_points": {"K45": 1},
            "interpolation": {"K1": 1, "K3": 1}}
    for n, backend in ((1, "nccl"), (2, "gloo")):
        t0 = time.perf_counter()
        ranks = spawn_world(n, sharded_rank, (backend,), backend=backend, timeout=WORLD_TIMEOUT_S,
                            device="cuda")
        print(f"sharded world of {n} on {backend} (one card): {time.perf_counter() - t0:.1f} s "
              f"with its spawn, kernels' load and construction")
        for rank, r in enumerate(ranks):
            for step, launches in r["launches"].items():
                if launches != want[step]:
                    fail(f"sharded {backend} rank {rank} {step}: launches {launches}, "
                         f"expected {want[step]}")
            for step, err in r["err"].items():
                if not err <= SHARDED_RTOL[step]:
                    fail(f"sharded {backend} rank {rank} {step}: {err:.3e} from the unsharded "
                         f"engine > {SHARDED_RTOL[step]}")
            share = {s: f"{c:.4f} ms = {c / r['ms'][s]:.1%}" for s, c in
                     r["collective_ms"].items()}     # medians of the same calls
            print(f"sharded {backend} rank {rank} of {n} ({card}; points {r['shard']}): launches "
                  f"{json.dumps(r['launches'])}; step ms (host clock, median of {SHARD_REPS}) "
                  + ", ".join(f"{s} {m:.4f}" for s, m in r["ms"].items())
                  + f"; all_reduce {share}; vs unsharded "
                  + ", ".join(f"{s} {e:.2e}" for s, e in r["err"].items()))
        r0 = ranks[0]
        label = f"sharded full_zoo, rank 0 of {n}, {backend}"
        entries.append(entry(f"K45 pair_moments ({label})", "fiat_tpu_torch/csrc/moments.cu",
                             "fiat_tpu/ops/pallas_recurrence.py:549, "
                             "fiat_tpu/ops/pallas_recurrence.py:727",
                             r0["launches"]["moments"]["K45"], r0["k45"][0], r0["k45"][1],
                             r0["k45"][2], tuple(r0["k45"][3]), r0["k45"][4]))
        entries.append(entry(f"K2 bucket_matmul ({label})", "fiat_tpu_torch/csrc/bucket_matmul.cu",
                             "fiat_tpu/ops/pallas_multiword.py:269",
                             r0["launches"]["fused"]["K2"], r0["k2"][0], r0["k2"][1],
                             r0["k2"][2], tuple(r0["k2"][3]), r0["k2"][4]))
    return entries


#: phase 26's stamped wrappers of the symbolic bridge, (family, cell, degree):
#: degree 3 on the natural cell, degree 2 on the quadrilateral for the
#: hypercube families
SYMBOLIC_WRAPPERS = tuple(
    [(f, "T", 3) for f in ("Regge", "HellanHerrmannJohnson",
                           "GopalakrishnanLedererSchoberlFirstKind",
                           "GopalakrishnanLedererSchoberlSecondKind", "Bernstein", "Bubble",
                           "FacetBubble", "CrouzeixRaviart", "Lagrange", "DiscontinuousLagrange",
                           "DiscontinuousTaylor", "HDivTrace", "RaviartThomas",
                           "BrezziDouglasMarini", "BrezziDouglasFortinMarini", "Nedelec",
                           "NedelecSecondKind", "Real")]
    + [("Histopolation", "I", 3)]
    + [(f, "Q", 2) for f in ("Serendipity", "DPC", "TrimmedSerendipityEdge",
                             "TrimmedSerendipityFace", "TrimmedSerendipityDiv",
                             "TrimmedSerendipityCurl", "BrezziDouglasMariniCubeEdge",
                             "BrezziDouglasMariniCubeFace")])
SYMBOLIC_RTOL = 1e-10     # tensor path vs host, of max(1, max |table|) per alpha
DUAL_RTOL = 1e-12         # dual evaluation on the card vs host, of max(1, max |dofs|)


def edge_points(n, seed, np):
    """n points on the UFC triangle's edges, a third on each (the trace
    element's points)."""
    rng = np.random.default_rng(seed)
    s = rng.random(n)
    ends = np.array([[[0, 1], [1, 0]], [[0, 0], [0, 1]], [[0, 0], [1, 0]]], dtype=float)
    e = np.arange(n) % 3
    return ends[e, 0] * (1 - s)[:, None] + ends[e, 1] * s[:, None]


def symbolic_tables_check(name, tables, host, dev, torch, np):
    """The tensor path's tables against the host's on the first
    HOST_CHECK_PTS points: every table a float64 tensor on the card, the same alphas,
    exceptions (the trace element's gradients) alike; returns the worst
    error of max(1, max |table|)."""
    if set(tables) != set(host):
        fail(f"{name}: alphas {sorted(tables)} != host {sorted(host)}")
    worst = 0.0
    for a, want in host.items():
        got = tables[a]
        if isinstance(want, Exception):
            if type(got) is not type(want):
                fail(f"{name} {a}: {type(got).__name__}, host {type(want).__name__}")
            continue
        if not (torch.is_tensor(got) and got.device == dev and got.dtype == torch.float64):
            fail(f"{name} {a}: not a float64 tensor on {dev}: {type(got).__name__}")
        g = got[..., :HOST_CHECK_PTS].cpu().numpy()
        if g.shape != want.shape:
            fail(f"{name} {a}: shape {g.shape}, host {want.shape}")
        if not np.isfinite(g).all():
            fail(f"{name} {a}: non-finite values")
        worst = max(worst, float(np.abs(g - want).max()) / max(1.0, float(np.abs(want).max())))
    if not worst <= SYMBOLIC_RTOL:
        fail(f"{name}: tensor path vs host {worst:.3e} > {SYMBOLIC_RTOL}")
    return worst


def element_tabulator_cell(name, el, pts, card, torch, np, reference=None, tab=None,
                           bars=False):
    """``ElementTabulator(el, order=1)`` on the default device (``tab``
    where the caller built it) at ``pts``: one K1 and one K2 launch a
    call, each kernel against its plain version, the tables against host
    el.tabulate at HOST_ATOL (with ``bars``, at the element's ``table_bar``:
    phase 30) (and, where given, equal to ``reference``, another
    engine's tables); returns (its K1 and K2 kernels-line entries, the
    call's ms)."""
    from fiat_tpu_torch.ops.tabulate import ElementTabulator
    dev = torch.device("cuda", 0)
    P = torch.as_tensor(pts, device=dev)
    if tab is None:
        tab = ElementTabulator(el, order=1)        # the default device: the card
    if tab.device != dev:
        fail(f"{name}: ElementTabulator on {tab.device}, not {dev}")
    rec, mm = tab.recurrence, tab.matmul
    tables, launches = counted({"K1": rec, "K2": mm}, lambda: tab(P), torch)
    expect_launches(name, launches, {"K1": 1, "K2": 1})
    if not all(bool(torch.isfinite(t).all()) for t in tables.values()):
        fail(f"{name}: non-finite values in the tables")
    if bars:
        host_err = host_bars(name, [el], [tables], pts, NPTS, np)
    else:
        host_err = host_check([el], [tables], pts, NPTS, torch, np)
    print(f"{name} main path: ElementTabulator(order 1) at {NPTS} points, max abs err vs host "
          f"el.tabulate on {HOST_CHECK_PTS} points {host_err:.3e}")
    if not (bars or host_err <= HOST_ATOL):
        fail(f"{name}: tables disagree with host tabulation: {host_err:.3e} > {HOST_ATOL}")
    if reference is not None:
        same = all(torch.equal(tables[a], reference[a]) for a in reference)
        print(f"{name} tables equal to phase 5's tet_lagrange8 block tables: {same}")
        if not same or set(reference) != set(tables):
            fail(f"{name}: tables differ from phase 5's tet_lagrange8 block tables")
    del tables
    phi_p = rec.plain(P)
    k1_abs = check_kernel(f"{name} K1 recurrence (sd {rec.sd}, degree {rec.degree})", rec(P),
                          phi_p, torch)
    k2_abs = check_kernel(f"{name} K2 bucket matmul ({mm.total_rows} x {NPTS}, K {mm.max_k})",
                          mm(phi_p), mm.plain(phi_p), torch)
    del phi_p
    phi = rec(P)
    k1_ms, k1_plain = median_ms(lambda: rec(P), torch), median_ms(lambda: rec.plain(P), torch)
    k2_ms, k2_plain = median_ms(lambda: mm(phi), torch), median_ms(lambda: mm.plain(phi), torch)
    A = mm.A.to(phi.device)
    k2_lib = median_ms(lambda: torch.matmul(A, phi[:mm.max_k]), torch)   # one cuBLAS DGEMM
    call_ms = median_ms(lambda: tab(P), torch)
    k1_card, k2_card = device_ms(lambda: rec(P), torch), device_ms(lambda: mm(phi), torch)
    del phi, A
    card_ms = lambda ms: "not measured" if ms is None else f"{ms:.4f}"   # noqa: E731
    print(f"{name} timing ({card}; CUDA events, card = the profiler's device time): call "
          f"{call_ms:.4f} ms; K1 {k1_ms:.4f} ms (card {card_ms(k1_card)}, plain "
          f"{k1_plain:.4f}); K2 {k2_ms:.4f} ms = {k2_rates(mm, k2_ms)} (card "
          f"{card_ms(k2_card)}, plain {k2_plain:.4f}, cuBLAS DGEMM {k2_lib:.4f})")
    src = "fiat_tpu_torch/csrc/"
    return [entry(f"K1 dubiner{rec.sd}_values{generic(rec)} ({name})", src + "recurrence.cu",
                  "fiat_tpu/ops/pallas_recurrence.py:399", launches["K1"], k1_abs, k1_ms,
                  k1_plain, rec_bound(rec, NPTS)),
            entry(f"K2 bucket_matmul{wide(mm)} ({name})", src + "bucket_matmul.cu",
                  "fiat_tpu/ops/pallas_multiword.py:269", launches["K2"], k2_abs, k2_ms,
                  k2_plain, matmul_bound(mm, NPTS), k2_lib)], call_ms


def symbolic_phase(dev, card, torch, np, tet_engine=None):
    """Phase 26, the symbolic layer on the card.

    1. ``ops.tabulate.ElementTabulator`` on the default device: Lagrange 4
       on the triangle at ``pts2`` and Lagrange 8 on the tetrahedron
       (``tet_lagrange8``) at ``pts3``, order 1, one K1 and one K2 launch
       each, each kernel against its plain version, host parity at
       HOST_ATOL, the tet tables equal to phase 5's block tables
       (``tet_engine``, the same engine; built here when the phase runs
       alone).
    2. The symbolic layer's tensor path: ``basis_evaluation(1,
       UnknownPointSet(P))`` of every stamped wrapper (SYMBOLIC_WRAPPERS), a
       TensorProductElement, FlattenedDimensions on the quadrilateral, an
       EnrichedElement, a MixedElement of Lagrange 2 and RT 1, HDivElement
       and HCurlElement at 1e5 points on the card, each table held to the
       host's on HOST_CHECK_PTS points at SYMBOLIC_RTOL; dual evaluation of
       Lagrange 5 and RT 3 on a torch function on the card against the
       host's at DUAL_RTOL; the GLL Q8 hexahedron on a TensorPointSet of
       three 9-point GLL sets on the card, its identity pattern.  This path
       runs torch operations on the card, as fiat_tpu's traced path runs
       XLA outside any Pallas kernel: no kernel is launched or counted.

    Returns the kernels-line entries of part 1."""
    import fiat_tpu_torch as ft
    from fiat_tpu_torch import device_tabulator, symbolic as sym
    from fiat_tpu_torch.core.quadrature import GaussLobattoLegendreQuadratureLineRule
    from fiat_tpu_torch.symbolic.point_set import (GaussLobattoLegendrePointSet, PointSet,
                                                   TensorPointSet, UnknownPointSet)

    T, S, I, Q = ft.ufc_simplex(2), ft.ufc_simplex(3), ft.ufc_simplex(1), ft.UFCQuadrilateral()
    pts2 = make_points(NPTS, SEED, np)
    pts3 = make_points(NPTS, SEED, np, sd=3)
    P3 = torch.as_tensor(pts3, device=dev)
    if tet_engine is None:
        tet_engine = device_tabulator(tet_zoos(S)[0], order=1)
    phase5 = tet_engine.unpack(tet_engine.block_tables(P3))[0]
    kernels, tri_ms = element_tabulator_cell("ElementTabulator lagrange4 tri", ft.Lagrange(T, 4),
                                             pts2, card, torch, np)
    lag8 = tet_zoos(S)[0][0]
    tet_kernels, tet_ms = element_tabulator_cell("ElementTabulator tet_lagrange8", lag8, pts3,
                                                 card, torch, np, reference=phase5)
    kernels += tet_kernels
    del phase5

    print("symbolic tensor path: torch operations on the card (the expansion recurrence and "
          "torch.matmul, einsum, cat, stack), no hand-written kernel, as fiat_tpu's traced "
          "path runs XLA outside any Pallas kernel; nothing of it is counted as a kernel")
    cells = {"T": T, "I": I, "Q": Q}
    rng = np.random.default_rng(SEED + 26)
    points = {"T": pts2, "I": make_points(NPTS, SEED, np, sd=1), "Q": rng.random((NPTS, 2)),
              "edges": edge_points(NPTS, SEED, np)}
    on_card = {k: torch.as_tensor(v, device=dev) for k, v in points.items()}
    cases = [(f"{f} {d} on {c}", getattr(sym, f)(cells[c], d),
              "edges" if f == "HDivTrace" else c) for f, c, d in SYMBOLIC_WRAPPERS]
    cases += [
        ("TensorProductElement(Lagrange 3, DG 2) on I x I",
         sym.TensorProductElement([sym.Lagrange(I, 3), sym.DiscontinuousLagrange(I, 2)]), "Q"),
        ("FlattenedDimensions(Lagrange 3 x Lagrange 3) on Q",
         sym.FlattenedDimensions(sym.TensorProductElement([sym.Lagrange(I, 3)] * 2)), "Q"),
        ("EnrichedElement(Lagrange 1, Bubble 3)",
         sym.EnrichedElement([sym.Lagrange(T, 1), sym.Bubble(T, 3)]), "T"),
        ("MixedElement(Lagrange 2, RT 1)",
         sym.MixedElement([sym.Lagrange(T, 2), sym.RaviartThomas(T, 1)]), "T"),
        ("HDivElement(Lagrange 2 x DG 1)", sym.HDivElement(sym.TensorProductElement(
            [sym.Lagrange(I, 2), sym.DiscontinuousLagrange(I, 1)])), "Q"),
        ("HCurlElement(DG 1 x Lagrange 2)", sym.HCurlElement(sym.TensorProductElement(
            [sym.DiscontinuousLagrange(I, 1), sym.Lagrange(I, 2)])), "Q"),
    ]
    timings, worst = [], 0.0
    for name, el, where in cases:
        ps = UnknownPointSet(on_card[where])          # the default device: the card
        tables = el.basis_evaluation(1, ps)
        host = el.basis_evaluation(1, PointSet(points[where][:HOST_CHECK_PTS]))
        err = symbolic_tables_check(name, tables, host, dev, torch, np)
        worst = max(worst, err)
        del tables
        ms = host_timed(lambda el=el, ps=ps: el.basis_evaluation(1, ps), torch)
        timings.append(f"{name} {ms:.2f}")
        print(f"symbolic {name}: basis_evaluation(1) at {NPTS} points on the card {ms:.2f} ms "
              f"(host clock, synchronised; median of 5), vs host on {HOST_CHECK_PTS} points {err:.3e} of "
              f"max(1, max |table|)")
    print(f"symbolic tensor path: {len(cases)} elements at {NPTS} points, worst {worst:.3e} of "
          f"max(1, max |table|) vs host (bar {SYMBOLIC_RTOL})")

    sym_lag8 = sym.Lagrange(S, 8)
    ps3 = UnknownPointSet(P3)
    tables = sym_lag8.basis_evaluation(1, ps3)
    lag8_err = symbolic_tables_check("symbolic Lagrange 8 on S", tables, sym_lag8.basis_evaluation(
        1, PointSet(pts3[:HOST_CHECK_PTS])), dev, torch, np)
    del tables
    lag8_ms = host_timed(lambda: sym_lag8.basis_evaluation(1, ps3), torch)
    print(f"tet_lagrange8 order 1 at {NPTS} points ({card}): symbolic tensor path {lag8_ms:.2f} ms "
          f"(host clock, synchronised; {lag8_err:.3e} vs host) beside ElementTabulator "
          f"{tet_ms:.4f} ms (CUDA events; K1 + K2); Lagrange 4 on the triangle through "
          f"ElementTabulator {tri_ms:.4f} ms")

    def on_card_fn(xp_fn):
        return lambda ps: xp_fn(torch.as_tensor(ps.points, device=dev))

    scalar = lambda x: x[:, 0] ** 5 - 2.0 * x[:, 0] * x[:, 1] ** 2 + 1.0   # noqa: E731
    vector = lambda x: (torch.stack if torch.is_tensor(x) else np.stack)(    # noqa: E731
        [x[:, 1] ** 3 - x[:, 0], x[:, 0] * x[:, 1] ** 2 + 0.5], -1)
    for name, el, fn in (("Lagrange 5", sym.Lagrange(T, 5), scalar),
                         ("RT 3", sym.RaviartThomas(T, 3), vector)):
        got = el.dual_evaluation(on_card_fn(fn))
        want = el.dual_evaluation(lambda ps: fn(ps.points))
        if not (torch.is_tensor(got) and got.device == dev):
            fail(f"dual_evaluation of {name}: not a tensor on the card")
        err = float(np.abs(got.cpu().numpy() - want).max()) / max(1.0, float(np.abs(want).max()))
        ms = host_timed(lambda el=el, fn=fn: el.dual_evaluation(on_card_fn(fn)), torch)
        print(f"symbolic dual_evaluation of {name} ({len(want)} dofs) on a torch function on the "
              f"card: {ms:.2f} ms (host clock), vs host {err:.3e} of max(1, max |dofs|)")
        if not err <= DUAL_RTOL:
            fail(f"dual_evaluation of {name}: {err:.3e} > {DUAL_RTOL}")

    gll = sym.GaussLobattoLegendre(I, 8)
    hexa = sym.TensorProductElement([gll, gll, gll])
    x = torch.as_tensor(GaussLobattoLegendreQuadratureLineRule(I, 9).get_points(), device=dev)
    nodes = TensorPointSet([GaussLobattoLegendrePointSet(x)] * 3)
    tab = hexa.basis_evaluation(0, nodes)[(0, 0, 0)]
    eye = torch.eye(9 ** 3, dtype=torch.float64, device=dev)
    if tuple(tab.shape) != (9,) * 6 or tab.device != dev or not torch.equal(
            tab.reshape(9 ** 3, 9 ** 3), eye):
        fail("GLL Q8 hexahedron: the table at its own GLL nodes is not the identity on the card")
    hex_ms = host_timed(lambda: hexa.basis_evaluation(0, nodes), torch)
    print(f"symbolic GLL Q8 hexahedron on a TensorPointSet of three 9-point GLL sets on the card: "
          f"table {tuple(tab.shape)} is the identity (sum-factorised spectral delta), "
          f"{hex_ms:.2f} ms (host clock)")
    return kernels


# -- phase 27: the physically mapped ("zany") elements ------------------------------------

#: tests/test_zany_mapping.py's cases, (symbolic class, cell dimension, args,
#: kwargs): its test_zany_scalar (:148-167) and test_zany_piola (:173-193)
ZANY_SCALAR = (
    ("Hermite", 2, (), {}), ("Hermite", 3, (), {}), ("Morley", 2, (), {}),
    ("Morley", 3, (), {}), ("Bell", 2, (), {}), ("Argyris", 2, (5,), {"avg": True}),
    ("Argyris", 2, (6,), {"avg": True}), ("Argyris", 2, (5,), {"variant": "point"}),
    ("HsiehCloughTocher", 2, (3,), {"avg": True}), ("HsiehCloughTocher", 2, (4,), {"avg": True}),
    ("ReducedHsiehCloughTocher", 2, (), {}), ("QuadraticPowellSabin6", 2, (), {}),
    ("QuadraticPowellSabin12", 2, (), {"avg": True}), ("WuXuH3NC", 2, (), {}),
    ("WuXuRobustH3NC", 2, (), {}), ("BrambleZlamalC2", 2, (), {}), ("AlfeldC2", 2, (), {}),
    ("Walkington", 3, (), {}))
ZANY_PIOLA = (
    ("ArnoldWinther", 2, (), {}), ("ArnoldWintherNC", 2, (), {}), ("HuZhang", 2, (3,), {}),
    ("HuZhang", 2, (4,), {}), ("MardalTaiWinther", 2, (), {}), ("MardalTaiWinther", 3, (), {}),
    ("JohnsonMercier", 2, (), {}), ("JohnsonMercier", 3, (), {}), ("BernardiRaugel", 2, (), {}),
    ("BernardiRaugel", 3, (), {}), ("ChristiansenHu", 2, (), {}), ("ChristiansenHu", 3, (), {}),
    ("AlfeldSorokina", 2, (), {}), ("AlfeldSorokina", 3, (), {}), ("ReducedArnoldQin", 2, (), {}),
    ("GuzmanNeilanFirstKindH1", 2, (), {}), ("GuzmanNeilanFirstKindH1", 3, (), {}),
    ("GuzmanNeilanSecondKindH1", 2, (), {}), ("GuzmanNeilanH1div", 2, (), {}))
#: full_zoo's six zany families (bench.py:846-848) as symbolic elements, (class, args)
ZOO_ZANY = (("Hermite", ()), ("Morley", ()), ("Argyris", (5,)), ("Bell", ()),
            ("HsiehCloughTocher", (3,)), ("QuadraticPowellSabin6", ()))
ZANY_M_RTOL = 1e-13       # M from tensor geometry vs numpy geometry, of max(1, max |M|)
ZANY_PHYS_ATOL = 1e-9     # the physical check (tests/test_zany_mapping.py:143)
MESH_CELLS = 100_000
MESH_SAMPLES = 64
MESH_RULE = 10            # degree of the triangle rule the mesh's tables are mapped at
#: tests/test_direct_serendipity.py's distorted quadrilateral
DS_VERTS = ((0.0, 0.0), (1.0, 0.0), (0.1, 1.1), (0.95, 1.01))


def distorted_vertices(dim):
    """tests/test_zany_mapping.py's distorted physical simplex
    (``_distorted_cells``)."""
    if dim == 2:
        return ((0.0, 0.1), (1.17, -0.09), (0.15, 1.84))
    return ((0, 0, 0.1), (1.17, -0.09, 0.0), (0.15, 1.84, -0.02), (0.11, 0.17, 1.19))


class SimplexGeometry:
    """The ``symbolic.PhysicalGeometry`` callbacks of an affinely mapped UFC
    simplex, computed from its vertices ``verts`` (nvertex, sd) by array
    operations: numpy for a numpy array; torch on the tensor's device for a
    tensor, also over a batch of cells under ``torch.func.vmap``.  The
    conventions are the UFC cells' (``compute_normal``), as
    tests/test_zany_mapping.py's MyMapping reads them off a cell with moved
    vertices: a facet normal is the edge tangent rotated (triangle) or -2
    times the unit cross product of the face's tangents (tetrahedron);
    tangents are unit; the cell size is 1 at each vertex."""

    def __init__(self, ref_cell, verts):
        import numpy as np
        self.np, self.ref_cell, self.verts = np, ref_cell, verts
        self.torch = None if isinstance(verts, np.ndarray) else __import__("torch")
        self.sd = ref_cell.get_spatial_dimension()
        self.top = ref_cell.get_topology()
        R = np.asarray(ref_cell.get_vertices(), dtype=np.float64)
        self._R0, self._Rinv = R[0], np.linalg.inv((R[1:] - R[0]).T)

    def _const(self, x):
        """A numpy constant beside the vertices: numpy, or on their device."""
        x = self.np.asarray(x, dtype=self.np.float64)
        return x if self.torch is None else self.torch.as_tensor(x, device=self.verts.device)

    def _norm(self, a):
        if self.torch is None:
            return self.np.linalg.norm(a, axis=-1)
        return self.torch.linalg.vector_norm(a, dim=-1)

    def _tangents(self, dim):
        """v_1 - v_0, ..., v_dim - v_0 of each dim-entity: (nentity, dim, sd)."""
        ids = self.np.array([self.top[dim][e] for e in sorted(self.top[dim])])
        if self.torch is not None:
            ids = self.torch.as_tensor(ids, device=self.verts.device)
        V = self.verts[ids]
        return V[:, 1:] - V[:, :1]

    def jacobian_at(self, point):
        return (self.verts[1:] - self.verts[0]).T @ self._const(self._Rinv)

    def detJ_at(self, point):
        return (self.torch or self.np).linalg.det(self.jacobian_at(point))

    def cell_size(self):
        return self._const(self.np.ones(self.sd + 1))

    def reference_normals(self):
        return self._const([self.ref_cell.compute_normal(f)
                            for f in sorted(self.top[self.sd - 1])])

    def normalized_reference_edge_tangents(self):
        return self._const([self.ref_cell.compute_normalized_edge_tangent(e)
                            for e in sorted(self.top[1])])

    def physical_normals(self):
        t = self._tangents(self.sd - 1)
        if self.sd == 2:
            n = (self.torch or self.np).stack([t[:, 0, 1], -t[:, 0, 0]], -1)
            return n / self._norm(n)[:, None]
        if self.torch is None:
            n = self.np.cross(t[:, 0], t[:, 1])
        else:
            n = self.torch.linalg.cross(t[:, 0], t[:, 1], dim=-1)
        return -2.0 * n / self._norm(n)[:, None]

    def physical_tangents(self):
        t = self._tangents(1)[:, 0]
        return t / self._norm(t)[:, None]

    def physical_edge_lengths(self):
        return self._norm(self._tangents(1)[:, 0])

    def physical_points(self, ps, entity=None):
        assert entity is None
        J = self.jacobian_at(None)
        x = ps.points
        if self.torch is not None and not self.torch.is_tensor(x):
            x = self._const(x)
        return x @ J.T + (self.verts[0] - J @ self._const(self._R0))

    def physical_vertices(self):
        return self.verts


class QuadMapping:
    """tests/test_direct_serendipity.py's bilinear map of the UFC square
    onto a convex quadrilateral, the callbacks DirectSerendipity reads, on
    numpy or tensor vertices (tensor points then)."""

    def __init__(self, verts):
        self.verts = verts

    def physical_points(self, ps, entity=None):
        assert entity is None
        p, v = ps.points, self.verts
        sx, sy = p[..., 0:1], p[..., 1:2]
        return (v[0] * (1 - sx) * (1 - sy) + v[1] * (1 - sx) * sy
                + v[2] * sx * (1 - sy) + v[3] * sx * sy)

    def physical_vertices(self):
        return self.verts


def unisolvent_points(element, interior=False):
    """tests/test_zany_mapping.py's ``make_unisolvent_points``."""
    degree = element.degree()
    ref_complex = element.get_reference_complex()
    top = ref_complex.get_topology()
    pts = []
    if interior:
        dim = ref_complex.get_spatial_dimension()
        for entity in top[dim]:
            pts.extend(ref_complex.make_points(dim, entity, degree + dim + 1, variant="gll"))
    else:
        for dim in top:
            for entity in top[dim]:
                pts.extend(ref_complex.make_points(dim, entity, degree, variant="gll"))
    return pts


def zany_physical_check(name, dim, args, kwargs, M, np):
    """tests/test_zany_mapping.py's ``check_zany_mapping`` on the port: the
    element's transformation ``M`` on the distorted cell (numpy, or a tensor
    on its device, where the product runs) applied to the Piola-mapped
    reference tables at unisolvent points reproduces the tables of the
    element built on the physical cell; returns the max abs error."""
    import torch
    from fiat_tpu_torch import symbolic as sym, ufc_simplex
    from fiat_tpu_torch.core.cells import make_affine_mapping
    ref_cell, phys_cell = ufc_simplex(dim), ufc_simplex(dim)
    phys_cell.vertices = distorted_vertices(dim)
    cls = getattr(sym, name)
    finat_element = cls(ref_cell, *args, **kwargs)
    ref_element = finat_element._element
    phys_element = cls(phys_cell, *args, **kwargs).fiat_equivalent
    sd = ref_cell.get_spatial_dimension()
    shape = ref_element.value_shape()
    ref_vals = ref_element.tabulate(0, unisolvent_points(ref_element, True))[(0,) * sd]
    phys_vals = phys_element.tabulate(0, unisolvent_points(phys_element, True))[(0,) * sd]
    map_name = ref_element.mapping()[0]
    if map_name == "affine":
        piola_vals = ref_vals
    else:
        J, _ = make_affine_mapping(ref_cell.vertices, phys_cell.vertices)
        K = []
        if "covariant" in map_name:
            K.append(np.linalg.inv(J).T)
        if "contravariant" in map_name:
            K.append(J / np.linalg.det(J))
        piola_vals = np.zeros(ref_vals.shape)
        for i in range(ref_vals.shape[0]):
            for k in range(ref_vals.shape[-1]):
                x = ref_vals[i, ..., k]
                piola_vals[i, ..., k] = K[0] @ x @ K[-1].T if len(shape) == 2 else K[0] @ x
    num_dofs = finat_element.space_dimension()
    if torch.is_tensor(M):
        zany = torch.tensordot(M, torch.as_tensor(piola_vals, device=M.device), ([-1], [0]))
        zany = zany.cpu().numpy()
    else:
        zany = np.tensordot(M, piola_vals, (-1, 0))
    return float(np.abs(zany - phys_vals[:num_dofs]).max())


def tables_on(tabs):
    """Every table of a (lazy) tabulation, computed: {alpha: table}."""
    return {a: tabs[a] for a in tabs}


def transformation_check(label, el, geom, geom_np, dev, torch, np):
    """M from tensor geometry on the card (float64 on ``dev``) against M from
    numpy geometry at ZANY_M_RTOL of max(1, max |M|); returns (M on the
    card, error)."""
    from fiat_tpu_torch.symbolic.physically_mapped import to_dense
    M = to_dense(el.basis_transformation(geom))
    want = to_dense(el.basis_transformation(geom_np))
    if not (torch.is_tensor(M) and M.device == dev and M.dtype == torch.float64):
        fail(f"{label}: M is not a float64 tensor on {dev}: {type(M).__name__}")
    if tuple(M.shape) != want.shape:
        fail(f"{label}: M {tuple(M.shape)}, numpy geometry's {want.shape}")
    err = float(np.abs(M.cpu().numpy() - want).max()) / max(1.0, float(np.abs(want).max()))
    if not err <= ZANY_M_RTOL:
        fail(f"{label}: M on the card vs numpy geometry {err:.3e} > {ZANY_M_RTOL}")
    return M, err


def mesh_vertices(n, np):
    """n distorted triangles: the UFC triangle's vertices each moved by up
    to 0.2 in each coordinate (so every Jacobian determinant is at least
    0.2), scaled by 0.1-2 and shifted by up to 1, from a seed."""
    rng = np.random.default_rng(SEED + 27)
    V = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]]) + rng.uniform(-0.2, 0.2, (n, 3, 2))
    V = V * rng.uniform(0.1, 2.0, (n, 1, 1)) + rng.uniform(-1.0, 1.0, (n, 1, 2))
    E = V[:, 1:] - V[:, :1]
    if not (E[:, 0, 0] * E[:, 1, 1] - E[:, 0, 1] * E[:, 1, 0] > 0).all():
        fail("mesh: a cell with a Jacobian determinant <= 0")
    return V


def zany_cells_part(dev, card, torch, np):
    """Phase 27, part 1: each of the ZANY_SCALAR and ZANY_PIOLA elements on
    its distorted cell, the geometry's callbacks float64 tensors on the
    card: M vs numpy geometry, ``basis_evaluation(1, UnknownPointSet(P),
    coordinate_mapping=...)`` at 1e5 points vs the host's mapped tables,
    the physical check on the card."""
    import fiat_tpu_torch as ft
    from fiat_tpu_torch import symbolic as sym
    from fiat_tpu_torch.symbolic.point_set import PointSet, UnknownPointSet
    points = {2: make_points(NPTS, SEED, np), 3: make_points(NPTS, SEED, np, sd=3)}
    on_card = {d: UnknownPointSet(torch.as_tensor(p), device=dev) for d, p in points.items()}
    worst = {"M": 0.0, "tables": 0.0, "physical": 0.0}
    for name, dim, args, kwargs in ZANY_SCALAR + ZANY_PIOLA:
        label = f"zany {name}{args}{kwargs or ''} on {'T' if dim == 2 else 'S'}"
        cell = ft.ufc_simplex(dim)
        el = getattr(sym, name)(cell, *args, **kwargs)
        verts = np.asarray(distorted_vertices(dim), dtype=np.float64)
        geom, geom_np = SimplexGeometry(cell, torch.as_tensor(verts, device=dev)), \
            SimplexGeometry(cell, verts)
        M, m_err = transformation_check(label, el, geom, geom_np, dev, torch, np)
        tables = tables_on(el.basis_evaluation(1, on_card[dim], coordinate_mapping=geom))
        host = tables_on(el.basis_evaluation(1, PointSet(points[dim][:HOST_CHECK_PTS]),
                                             coordinate_mapping=geom_np))
        t_err = symbolic_tables_check(label, tables, host, dev, torch, np)
        del tables
        p_err = zany_physical_check(name, dim, args, kwargs, M, np)
        if not p_err <= ZANY_PHYS_ATOL:
            fail(f"{label}: the physical check on the card {p_err:.3e} > {ZANY_PHYS_ATOL}")
        m_ms = host_timed(lambda el=el, geom=geom: el.basis_transformation(geom), torch)
        ms = host_timed(lambda el=el, geom=geom: tables_on(el.basis_evaluation(
            1, on_card[dim], coordinate_mapping=geom)), torch)
        for k, v in (("M", m_err), ("tables", t_err), ("physical", p_err)):
            worst[k] = max(worst[k], v)
        print(f"{label}: M {tuple(M.shape)} on the card {m_ms:.2f} ms, vs numpy geometry "
              f"{m_err:.3e} of max(1, max |M|); basis_evaluation(1) at {NPTS} points "
              f"{ms:.2f} ms (host clock, synchronised; median of {SHARD_REPS}), vs host on "
              f"{HOST_CHECK_PTS} points {t_err:.3e} of max(1, max |table|); physical check "
              f"{p_err:.3e}")
    print(f"zany part 1 ({card}): {len(ZANY_SCALAR + ZANY_PIOLA)} elements; worst M "
          f"{worst['M']:.3e} (bar {ZANY_M_RTOL}), tables {worst['tables']:.3e} (bar "
          f"{SYMBOLIC_RTOL}), physical {worst['physical']:.3e} (bar {ZANY_PHYS_ATOL})")


def zany_mesh_part(dev, card, torch, np):
    """Phase 27, part 2: M of full_zoo's six zany families over MESH_CELLS
    distorted triangles in one ``torch.func.vmap`` of
    ``basis_transformation`` each, MESH_SAMPLES cells held to M from numpy
    geometry; the reference tables at a degree-MESH_RULE rule, order 1,
    mapped for every cell in one batched product, the sampled cells held
    to the host's mapped tables."""
    import fiat_tpu_torch as ft
    from fiat_tpu_torch import symbolic as sym
    from fiat_tpu_torch.symbolic.physically_mapped import to_dense
    from fiat_tpu_torch.symbolic.point_set import PointSet
    from fiat_tpu_torch.symbolic.quadrature import make_quadrature
    T = ft.ufc_simplex(2)
    V = mesh_vertices(MESH_CELLS, np)
    Vc = torch.as_tensor(V, device=dev)
    samples = np.random.default_rng(SEED + 28).choice(MESH_CELLS, MESH_SAMPLES, replace=False)
    qpts = make_quadrature(T, MESH_RULE).point_set.points
    for name, args in ZOO_ZANY:
        el = getattr(sym, name)(T, *args)

        def build(el=el):
            return torch.func.vmap(lambda v: to_dense(el.basis_transformation(
                SimplexGeometry(T, v))))(Vc)

        M = build()
        ndof, nrows = el.space_dimension(), el._element.space_dimension()
        if tuple(M.shape) != (MESH_CELLS, ndof, nrows) or M.device != dev \
                or not bool(torch.isfinite(M).all()):
            fail(f"mesh {name}: M {tuple(M.shape)} on {M.device}, finite "
                 f"{bool(torch.isfinite(M).all())}")
        ref = el._element.tabulate(1, qpts)
        alphas = sorted(ref)
        R = torch.as_tensor(np.stack([ref[a] for a in alphas]), device=dev)

        def mapped(M=M, R=R):
            return torch.matmul(M[:, None], R[None])       # (cells, alphas, ndof, points)

        out = mapped()
        m_err = t_err = 0.0
        for c in samples:
            geom = SimplexGeometry(T, V[c])
            want = to_dense(el.basis_transformation(geom))
            m_err = max(m_err, float(np.abs(M[c].cpu().numpy() - want).max())
                        / max(1.0, float(np.abs(want).max())))
            host = el.basis_evaluation(1, PointSet(qpts), coordinate_mapping=geom)
            got = out[c].cpu().numpy()
            for k, a in enumerate(alphas):
                t_err = max(t_err, float(np.abs(got[k] - host[a]).max())
                            / max(1.0, float(np.abs(host[a]).max())))
        if not m_err <= ZANY_M_RTOL:
            fail(f"mesh {name}: M under vmap vs numpy geometry {m_err:.3e} > {ZANY_M_RTOL}")
        if not t_err <= SYMBOLIC_RTOL:
            fail(f"mesh {name}: mapped tables vs host {t_err:.3e} > {SYMBOLIC_RTOL}")
        del out
        build_ms, map_ms = host_timed(build, torch), host_timed(mapped, torch)
        print(f"mesh {name}{args} ({card}): M over {MESH_CELLS} cells in one vmap "
              f"{tuple(M.shape)}, {M.numel() * 8 / 1e6:.1f} MB, {build_ms:.2f} ms; mapped "
              f"{len(alphas)} tables at {len(qpts)} points for every cell in one batched "
              f"product {map_ms:.2f} ms (host clock, synchronised; median of {SHARD_REPS}); "
              f"{MESH_SAMPLES} sampled cells vs numpy geometry: M {m_err:.3e}, tables "
              f"{t_err:.3e}")
        del M, R


def zany_engine_part(dev, card, torch, np, zoo_engine=None):
    """Phase 27, part 3: full_zoo's f64 kernel engine (phase 2's, or built
    here), one ``block_tables`` call at ``pts2`` (K1, K2, K3 once each),
    each zany element's blocks mapped by its M on part 1's cell through
    ``MappedTabulation``, held to the symbolic tensor path's tables."""
    import fiat_tpu_torch as ft
    from fiat_tpu_torch import device_tabulator, symbolic as sym
    from fiat_tpu_torch.symbolic.physically_mapped import MappedTabulation
    from fiat_tpu_torch.symbolic.point_set import UnknownPointSet
    T = ft.ufc_simplex(2)
    zoo_zany = full_zoo_zany(T)
    syms = [getattr(sym, name)(T, *args) for name, args in ZOO_ZANY]
    for s, e in zip(syms, zoo_zany):
        a = s._element
        same = (type(a) is type(e) and a.space_dimension() == e.space_dimension()
                and a.entity_dofs() == e.entity_dofs()
                and np.array_equal(a.get_coeffs(), e.get_coeffs()))
        if not same:
            fail(f"zany engine: {type(s).__name__}'s element is not full_zoo's {type(e).__name__}")
    tab = zoo_engine if zoo_engine is not None else device_tabulator(full_zoo(T), order=1,
                                                                     device=dev)
    P = torch.as_tensor(make_points(NPTS, SEED, np), device=dev)
    ps = UnknownPointSet(P, device=dev)
    verts = torch.as_tensor(distorted_vertices(2), dtype=torch.float64, device=dev)
    geom = SimplexGeometry(T, verts)
    blocks, launches = counted({"K1": tab.recurrence, "K2": tab.matmul, "K3": merged_macro(tab)},
                               lambda: tab.block_tables(P), torch)
    expect_launches("zany engine", launches, {"K1": 1, "K2": 1, "K3": 1})
    per = tab.unpack(blocks)[-len(syms):]
    worst = 0.0
    for s, ref in zip(syms, per):
        got = tables_on(MappedTabulation(s.basis_transformation(geom), ref))
        want = tables_on(s.basis_evaluation(1, ps, coordinate_mapping=geom))
        if set(got) != set(want):
            fail(f"zany engine {type(s).__name__}: alphas {sorted(got)} != {sorted(want)}")
        for a, w in want.items():
            err = (got[a] - w).abs().max().item() / max(1.0, w.abs().max().item())
            worst = max(worst, err)
            if not err <= SYMBOLIC_RTOL:
                fail(f"zany engine {type(s).__name__} {a}: engine + map vs tensor path "
                     f"{err:.3e} > {SYMBOLIC_RTOL}")
    del blocks, per

    def engine_and_map():
        per = tab.unpack(tab.block_tables(P))[-len(syms):]
        return [tables_on(MappedTabulation(s.basis_transformation(geom), ref))
                for s, ref in zip(syms, per)]

    def tensor_path():
        return [tables_on(s.basis_evaluation(1, ps, coordinate_mapping=geom)) for s in syms]

    engine_ms, tensor_ms = host_timed(engine_and_map, torch), host_timed(tensor_path, torch)
    print(f"zany engine ({card}): full_zoo's f64 engine, one block_tables call (K1, K2, K3 "
          f"once each), the six zany elements' blocks mapped by their M: vs the tensor path "
          f"{worst:.3e} of max(1, max |table|); engine + map (the whole zoo's tables, M "
          f"built each call) {engine_ms:.2f} ms beside the tensor path of the six "
          f"{tensor_ms:.2f} ms (host clock, synchronised; median of {SHARD_REPS})")


def direct_serendipity_part(dev, card, torch, np):
    """Phase 27, part 4: DirectSerendipity 1-4 on DS_VERTS, tensor vertices
    and 1e5 tensor points on the card, held to the host's numpy
    evaluation."""
    import fiat_tpu_torch as ft
    from fiat_tpu_torch import symbolic as sym
    from fiat_tpu_torch.symbolic.point_set import PointSet, UnknownPointSet
    Q = ft.UFCQuadrilateral()
    pts = np.random.default_rng(SEED + 29).random((NPTS, 2))
    ps = UnknownPointSet(torch.as_tensor(pts), device=dev)
    geom = QuadMapping(torch.as_tensor(DS_VERTS, dtype=torch.float64, device=dev))
    geom_np = QuadMapping(np.asarray(DS_VERTS, dtype=np.float64))
    for degree in (1, 2, 3, 4):
        t0 = time.perf_counter()
        el = sym.DirectSerendipity(Q, degree)
        host = el.basis_evaluation(1, PointSet(pts[:HOST_CHECK_PTS]), coordinate_mapping=geom_np)
        build_s = time.perf_counter() - t0
        label = f"DirectSerendipity {degree}"
        err = symbolic_tables_check(label, el.basis_evaluation(1, ps, coordinate_mapping=geom),
                                    host, dev, torch, np)
        ms = host_timed(lambda el=el: el.basis_evaluation(1, ps, coordinate_mapping=geom), torch)
        print(f"{label} ({card}): {el.space_dimension()} functions, basis_evaluation(1) of tensor "
              f"vertices at {NPTS} tensor points on the card {ms:.2f} ms (host clock, "
              f"synchronised; median of {SHARD_REPS}), vs host on {HOST_CHECK_PTS} points "
              f"{err:.3e} of max(1, max |table|); sympy basis and host evaluation {build_s:.1f} s")


def zany_phase(dev, card, torch, np, zoo_engine=None):
    """Phase 27, the physically mapped ("zany") elements on the card: parts
    1-4 (``zany_cells_part``, ``zany_mesh_part``, ``zany_engine_part`` on
    ``zoo_engine``, phase 2's engine, or one built here when the phase runs
    alone, ``direct_serendipity_part``).  M and the mapped tables are torch
    operations on the card, as fiat_tpu builds and applies M in XLA outside
    any Pallas kernel: no kernel is counted but the engine's K1, K2 and K3
    in part 3, which adds no kernels-line entry."""
    print("zany: M and the mapped tables are torch operations on the card (entrywise scalar "
          "algebra, torch.stack / cat, one product), no hand-written kernel; only part 3's "
          "engine call launches kernels (K1, K2, K3)")
    zany_cells_part(dev, card, torch, np)
    zany_mesh_part(dev, card, torch, np)
    zany_engine_part(dev, card, torch, np, zoo_engine)
    direct_serendipity_part(dev, card, torch, np)
    return []


# -- phase 28: descriptions through the factory -------------------------------------------

MASS_DEGREE = 4           # examples/assemble_mass.py's Lagrange 4, at its degree-8 rule
MASS_VOLUME_ATOL = 1e-14  # sum(M) vs the cell's volume
MASS_NULL_ATOL = 1e-12    # |K @ 1|: the stiffness matrix annihilates constants
MASS_HOST_RTOL = 1e-13    # M, K on the card vs a host numpy assembly, of max(1, max |entry|)


def factory_zoo_part(dev, card, torch, np, zoo_engine=None, zoo_ms=None):
    """Phase 28, part 1: full_zoo's 42 elements written as descriptions
    (``full_zoo_descriptions``), converted by ``create_element`` and put
    through ``device_tabulator(..., order=1)`` on the default device: each
    kernel against its plain version, one pass that launches K1, K2 and K3
    once each, host parity, and the block tables equal bit for bit to
    ``zoo_engine``'s (phase 2's engine on ``full_zoo(T)``; built here when
    the phase runs alone).  Equal tables come from equal arrays, so the
    kernels' times are phase 2's (``zoo_ms``), measured on this engine only
    when the phase runs alone.  Returns (the K1, K2 and K3 entries, the
    engine, the points on the card)."""
    import fiat_tpu_torch as ft
    from fiat_tpu_torch import create_element, device_tabulator, ufl

    T = ft.ufc_simplex(2)
    pts2 = make_points(NPTS, SEED, np)
    P = torch.as_tensor(pts2, device=dev)
    t0 = time.perf_counter()
    descs = full_zoo_descriptions(ufl)
    zoo = [create_element(d).fiat_equivalent for d in descs]
    t_elements = time.perf_counter() - t0
    tab = device_tabulator(zoo, order=1)            # the default device: the card
    t_build = time.perf_counter() - t0
    mo = merged_macro(tab)
    if len(zoo) != 42 or mo is None or tab.device != dev:
        fail(f"factory full_zoo: {len(zoo)} elements on {tab.device}, macro {mo is not None}")
    print(f"factory full_zoo host construction ({card}; host clock): 42 descriptions -> "
          f"create_element -> fiat_equivalent {t_elements:.3f} s, + device_tabulator "
          f"{t_build:.3f} s in all; {tab.rows} rows x {len(tab.alphas)} alphas, widths "
          f"{tab.widths}, K3 {mo.rows} x {mo.K} over {len(mo.nexp)} subcells")

    errs, launches, host_err = full_zoo_checks("factory full_zoo", tab, zoo, pts2, P, torch, np)
    if zoo_engine is None:
        zoo_engine = device_tabulator(full_zoo(T), order=1)
    got, want = tab.block_tables(P), zoo_engine.block_tables(P)
    same = set(got) == set(want) and all(
        len(got[a]) == len(want[a]) and all(torch.equal(g, w) for g, w in zip(got[a], want[a]))
        for a in want)
    print(f"factory full_zoo block tables equal to phase 2's engine on full_zoo(T): {same}")
    if not same:
        fail("factory full_zoo: block tables differ from phase 2's full_zoo engine")
    del got, want
    path_ms = median_ms(lambda: tab.block_tables(P), torch)
    source = "phase 2's, on equal arrays"
    if zoo_ms is None:
        zoo_ms, source = full_zoo_times(tab, P, torch), "this engine's"
    print(f"factory full_zoo timing ({card}; median of {REPS} runs of {INNER}, CUDA events): "
          f"pass {path_ms:.4f} ms; host error {host_err:.3e}; the kernels' times are {source}")
    return (full_zoo_entries(tab, errs, launches, zoo_ms, " (factory full_zoo)"), tab, P)


def mass_stiffness_part(desc, el, tab, dev, card, torch, np):
    """Phase 28, part 3: examples/assemble_mass.py on the card.  ``el``,
    the description ``desc`` (Lagrange 4, equispaced) through the factory,
    tabulated by ``tab``, its ``ElementTabulator`` (K1 + K2, one launch
    each), at ``create_quadrature(T, 8)``'s points, M and K formed by
    ``ir.contract``; sum(M) against the cell's volume, K @ 1 against 0,
    both against a host numpy assembly from ``tabulate``, and
    ``ir.cost_analysis`` of the contractions against their analytic
    counts."""
    import fiat_tpu_torch as ft
    from fiat_tpu_torch import create_quadrature, ir

    cell = ft.ufc_simplex(2)
    Q = create_quadrature(cell, 2 * MASS_DEGREE)
    qp, qw = Q.get_points(), Q.get_weights()
    X, W = torch.as_tensor(qp, device=dev), torch.as_tensor(qw, device=dev)
    tables, launches = counted({"K1": tab.recurrence, "K2": tab.matmul}, lambda: tab(X), torch)
    expect_launches("mass/stiffness ElementTabulator", launches, {"K1": 1, "K2": 1})
    phi = tables[(0, 0)]
    grads = torch.stack([tables[(1, 0)], tables[(0, 1)]])

    def assemble():
        return (ir.contract("iq,q,jq->ij", phi, W, phi),
                ir.contract("kiq,q,kjq->ij", grads, W, grads))

    M, K = assemble()
    ms = host_timed(assemble, torch)
    n, nq = phi.shape
    host = el.tabulate(1, qp)
    Mh = (host[(0, 0)] * qw) @ host[(0, 0)].T
    Gh = np.stack([host[(1, 0)], host[(0, 1)]])
    Kh = np.einsum("kiq,q,kjq->ij", Gh, qw, Gh)
    Mc, Kc = M.cpu().numpy(), K.cpu().numpy()
    volume_err = abs(Mc.sum() - cell.volume())
    null_err = float(np.abs(Kc @ np.ones(n)).max())
    m_err = float(np.abs(Mc - Mh).max()) / max(1.0, float(np.abs(Mh).max()))
    k_err = float(np.abs(Kc - Kh).max()) / max(1.0, float(np.abs(Kh).max()))
    product = ir.cost_analysis(lambda a, b: ir.contract("iq,jq->ij", a, b), phi * W, phi)
    chain = ir.cost_analysis(lambda a, w: ir.contract("iq,q,jq->ij", a, w, a), phi, W)
    print(f"mass/stiffness ({card}): {desc} ({n} dofs) at the degree-{2 * MASS_DEGREE} rule "
          f"({nq} points) on the card, M and K by ir.contract in {ms:.3f} ms (host clock, "
          f"synchronised); |sum(M) - volume| {volume_err:.3e}, |K @ 1| {null_err:.3e}, vs host "
          f"M {m_err:.3e}, K {k_err:.3e} of max(1, max |entry|); cost_analysis flops: product "
          f"{product['flops']:.0f} (2 n n nq = {2 * n * n * nq}), iq,q,jq->ij {chain['flops']:.0f} "
          f"(n nq + 2 n n nq = {n * nq + 2 * n * n * nq})")
    if not volume_err <= MASS_VOLUME_ATOL:
        fail(f"mass: sum(M) is {volume_err:.3e} from the cell's volume > {MASS_VOLUME_ATOL}")
    if not null_err <= MASS_NULL_ATOL:
        fail(f"stiffness: |K @ 1| {null_err:.3e} > {MASS_NULL_ATOL}")
    if not max(m_err, k_err) <= MASS_HOST_RTOL:
        fail(f"mass/stiffness vs host: M {m_err:.3e}, K {k_err:.3e} > {MASS_HOST_RTOL}")
    if product["flops"] != 2 * n * n * nq or chain["flops"] != n * nq + 2 * n * n * nq:
        fail(f"cost_analysis: {product['flops']} / {chain['flops']} flops, not the analytic "
             f"{2 * n * n * nq} / {n * nq + 2 * n * n * nq}")


def ir_part(dev, card, torch, np, P, engine):
    """Phase 28, part 4: ``ir`` on the card.  ``as_graph`` of the symbolic
    tensor path (Lagrange 4's ``basis_evaluation(1, UnknownPointSet(P))``)
    called on ``P`` equals the direct call bit for bit, ``evaluate`` on the
    host points moved to the card (its default) too; ``as_graph`` of the
    kernel engine's ``block_tables`` raises ``NotTraceable``: its kernels
    are launched through ctypes and no trace can hold them."""
    import fiat_tpu_torch as ft
    from fiat_tpu_torch import ir, symbolic as sym
    from fiat_tpu_torch.symbolic import UnknownPointSet

    el = sym.Lagrange(ft.ufc_simplex(2), 4)

    def tables(p):
        return el.basis_evaluation(1, UnknownPointSet(p))   # the default device: the card

    t0 = time.perf_counter()
    gm = ir.as_graph(tables, P)
    trace_s = time.perf_counter() - t0
    direct, traced = tables(P), gm(P)
    evaluated = ir.evaluate(tables, P.cpu().numpy())
    same = set(direct) == set(traced) == set(evaluated) and all(
        traced[a].device == dev and torch.equal(traced[a], direct[a])
        and torch.equal(evaluated[a], direct[a]) for a in direct)
    nodes = sum(1 for n in gm.graph.nodes if n.op == "call_function")
    graph_ms = host_timed(lambda: gm(P), torch)
    direct_ms = host_timed(lambda: tables(P), torch)
    print(f"ir on the card ({card}): as_graph of symbolic Lagrange 4 basis_evaluation(1) at "
          f"{NPTS} points: {nodes} aten calls, traced in {trace_s:.2f} s (host clock); graph "
          f"call {graph_ms:.2f} ms, direct call {direct_ms:.2f} ms (host clock, synchronised); "
          f"graph and evaluate equal to the direct call: {same}")
    if not same:
        fail("ir: the traced graph or evaluate differs from the direct call on the card")
    del direct, traced, evaluated
    try:
        ir.as_graph(engine.block_tables, P)
    except ir.NotTraceable as exc:
        print(f"ir: as_graph of the kernel engine's block_tables refused: {str(exc)[:120]}...")
    else:
        fail("ir: as_graph traced the kernel engine, whose ctypes launches no graph holds")


def factory_phase(dev, card, torch, np, zoo_engine=None, zoo_ms=None):
    """Phase 28, descriptions through the factory on the card: parts 1-4
    (``factory_zoo_part`` on ``zoo_engine`` and ``zoo_ms``, phase 2's
    engine and kernel times, or its own when the phase runs alone; Lagrange
    4 from its description, its one ``ElementTabulator`` through
    ``element_tabulator_cell`` and ``mass_stiffness_part``; ``ir_part``).
    Returns the kernels-line entries of parts 1 and 2."""
    import fiat_tpu_torch as ft
    from fiat_tpu_torch import create_element, ufl
    from fiat_tpu_torch.ops.tabulate import ElementTabulator

    kernels, engine, P = factory_zoo_part(dev, card, torch, np, zoo_engine, zoo_ms)
    desc = ufl.FiniteElement("Lagrange", "triangle", MASS_DEGREE, variant="equispaced")
    lag4 = create_element(desc).fiat_equivalent
    if type(lag4) is not ft.Lagrange:
        fail(f"factory: Lagrange 4 equispaced became {type(lag4).__name__}")
    tab = ElementTabulator(lag4, order=1)           # the default device: the card
    el_kernels, _ = element_tabulator_cell("ElementTabulator factory lagrange4", lag4,
                                           make_points(NPTS, SEED, np), card, torch, np, tab=tab)
    mass_stiffness_part(desc, lag4, tab, dev, card, torch, np)
    ir_part(dev, card, torch, np, P, engine)
    return kernels + el_kernels


def high_degree_phase(dev, card, torch, np):
    """Phase 29, ``high_degree``: the HIGH_DEGREE zoos at 1e5 points (pts2,
    pts3, the interval's phase 20 points) through every entry point
    (``zoo_phase``: f64 tables on K1 + K2 + K3, or K7 on the tet; moments on
    K45; interpolation on K1 + K3 one row a program; f32 tables on K6 + K3
    float32), each kernel's generic instantiation held to its plain version
    and counted on the main path, the tables to host (HIGH_DEGREE_FROM,
    HIGH_DEGREE_ILL, NO_DIGITS); then ``ElementTabulator`` on GLL Lagrange 20
    (triangle) and 14 (tet).  Every K1, K3, K45 and K6 of the phase must run
    its generic instantiation.  Its calls of LONG_CALL_MS or more are timed
    one call a sample (``calls_per_sample``)."""
    import fiat_tpu_torch as ft
    from fiat_tpu_torch import ufc_simplex

    global long_call_ms
    long_call_ms = LONG_CALL_MS
    try:
        # no K3 timed beside K7 on the tet: the f64 tables' K3 sd = 3 stage is
        # on no main path (K3's generic stages there are held to their plain
        # versions by tests/test_torch_high_degree.py)
        kernels = zoo_phase([(sd, name, lambda sd=sd, specs=specs: families_zoo(
            specs, (), ufc_simplex(sd))) for sd, name, specs in HIGH_DEGREE], dev, card, torch,
            np, k3_beside=False)
        stages = [k for k in kernels if k["name"].split()[0] in ("K1", "K3", "K45", "K6")]
        unrolled = [k["name"] for k in stages if "generic" not in k["name"]]
        if unrolled:
            fail(f"phase 29: stages on an unrolled instantiation: {unrolled}")
        for sd, degree in HIGH_DEGREE_ELEMENT:
            el = ft.Lagrange(ufc_simplex(sd), degree, variant="gll")
            pts = make_points(NPTS, SEED, np, sd=sd)
            entries, _ = element_tabulator_cell(
                f"ElementTabulator GLL Lagrange {degree} sd {sd}", el, pts, card, torch, np)
            kernels += entries
        return kernels
    finally:
        long_call_ms = None


#: phase 30, ``wide_basis``: the bases past the widths the port's kernels
#: once refused, at the degrees hp and spectral-element users run: K2 past
#: 792 (its streamed mode), K6 past 842 Phi rows (its wide mode).  GLL
#: Lagrange 15 (816 members), 16 (969) and 20 (1771) and DG 20 on the
#: tetrahedron (21,308 rows at order 1: 17 GB of f64 tables a pass), GLL
#: Lagrange 40 and DG 40 (861) on the triangle
WIDE = ((3, "wide_tet", (("Lagrange", 15, "gll"), ("Lagrange", 16, "gll"),
                         ("Lagrange", 20, "gll"), ("DiscontinuousLagrange", 20, None))),
        (2, "wide_tri", (("Lagrange", 40, "gll"), ("DiscontinuousLagrange", 40, None))))
#: phase 30's Bernstein elements: K8's generic instantiation at fiat_tpu's
#: highest degrees, by sd
BERNSTEIN_HIGH = {1: (26,), 2: (17,), 3: (15,)}
#: phase 30's Bernstein routes (``features="bernstein"``: K8 generic + K2) at
#: the top degrees, (sd, element, bar): tet GLL Lagrange 15 (K2 streamed)
#: held to host (None: ``host_bars``; 3.3e-11 of max(1, max |table|) on
#: the card); GLL Lagrange 26 on the interval and 17 on the triangle, whose
#: conversion M amplifies rounding past the host bar in both packages (4.6e-6
#: and 2.7e-10 from host, 6.8e-6 and 2.7e-10 from the Dubiner route's tables,
#: phase 30 on the card), held to the Dubiner route's tables at their bar of
#: max(1, max |table|) per alpha
WIDE_BERNSTEIN = ((3, ("Lagrange", 15, "gll"), None), (1, ("Lagrange", 26, "gll"), 2e-5),
                  (2, ("Lagrange", 17, "gll"), 1e-9))
#: phase 30's ElementTabulator case: (sd, GLL Lagrange degree)
WIDE_ELEMENT = (3, 20)
#: phase 30's float32 plain rows against its f64 tables, per alpha of its
#: max: the f32 recurrence's rounding grows with the degree (2.4e-5 on
#: ``wide_tri``, 1.1e-5 on ``wide_tet``, phase 30 on the card), past
#: HIGH_DEGREE_F32_RTOL; ``tests/test_torch_wide.py`` holds the f32 engine
#: to fiat_tpu's at tet 16
WIDE_F32_RTOL = 5e-5
#: K6's wide Phi stage against its plain version (the eager float32
#: recurrence), of max |Phi|: two float32 recurrences in another order of
#: operations (the kernel contracts to FMAs), whose rounding grows with the
#: degree (1.5e-5 at triangle 40, 4.4e-6 at tet 20, phase 30 on the card),
#: held at phase 30's f32 table bar, the tables these rows enter
WIDE_PHI_RTOL = WIDE_F32_RTOL


def wide_phase(dev, card, torch, np):
    """Phase 30, ``wide_basis``: the WIDE zoos at 1e5 points (pts3, pts2)
    through every entry point (``zoo_phase``: f64 tables on K1 + K2
    streamed; moments on K45; interpolation on K1; f32 tables on K6 wide,
    its Phi stage and its product), each kernel held to its plain version
    and counted on the main path, the tables to host; the Bernstein elements
    at BERNSTEIN_HIGH on K8's generic instantiation; ``features="bernstein"``
    on tet GLL Lagrange 15 (K8 generic + K2 streamed); ``ElementTabulator``
    on tet GLL Lagrange 20 (K1 + K2 streamed).  Every K2 of the phase must
    stream, every K6 run wide and every K8 run past 15 / 15 / 10.  Its calls
    of LONG_CALL_MS or more are timed one call a sample."""
    import fiat_tpu_torch as ft
    from fiat_tpu_torch import ufc_simplex

    global long_call_ms
    long_call_ms = LONG_CALL_MS
    try:
        kernels = zoo_phase([(sd, name, lambda sd=sd, specs=specs: families_zoo(
            specs, (), ufc_simplex(sd))) for sd, name, specs in WIDE], dev, card, torch, np,
            k3_beside=False)
        sd, degree = WIDE_ELEMENT
        el = ft.Lagrange(ufc_simplex(sd), degree, variant="gll")
        entries, _ = element_tabulator_cell(f"ElementTabulator GLL Lagrange {degree} sd {sd}", el,
                                            make_points(NPTS, SEED, np, sd=sd), card, torch, np,
                                            bars=True)
        kernels += entries
        # every K2 and K6 of the wide bases past their resident Phi tiles
        off = [k["name"] for k in kernels
               if (k["name"].startswith("K2 ") and " streamed" not in k["name"])
               or (k["name"].startswith("K6 zoo_f32") and " wide" not in k["name"])]
        kernels += bernstein_element_cell(dev, card, torch, np, BERNSTEIN_HIGH, "bernstein_high")
        for sd, spec, bar in WIDE_BERNSTEIN:
            pts = make_points(NPTS, SEED, np, sd=sd)
            entries = bernstein_cell(f"bernstein_high_route {spec[0]} {spec[1]} sd {sd}",
                                     families_zoo((spec,), (), ufc_simplex(sd)), pts,
                                     torch.as_tensor(pts, device=dev), card, torch, np, bar)
            kernels += entries
            off += [k["name"] for k in entries if sd == 3 and k["name"].startswith("K2 ")
                    and " streamed" not in k["name"]]
        # and every K8 past 15 / 15 / 10
        off += [k["name"] for k in kernels
                if k["name"].startswith("K8 ") and " generic" not in k["name"]]
        if off:
            fail(f"phase 30: kernels off the new modes: {off}")
        return kernels
    finally:
        long_call_ms = None


def new_phases(dev, card, torch, np, lap, only=(22, 23, 24, 25, 26, 27, 28, 29, 30),
               tet_engine=None, zoo_engine=None, zoo_ms=None):
    """Phases 22-30 (those in ``only``); returns their kernels-line entries."""
    phases = {22: lambda: rest_of_core_phase(dev, card, torch, np) or [],
              23: lambda: per_program_phase(dev, card, torch, np),
              24: lambda: jets_phase(dev, card, torch, np),
              25: lambda: sharded_phase(dev, card, torch, np),
              26: lambda: symbolic_phase(dev, card, torch, np, tet_engine),
              27: lambda: zany_phase(dev, card, torch, np, zoo_engine),
              28: lambda: factory_phase(dev, card, torch, np, zoo_engine, zoo_ms),
              29: lambda: high_degree_phase(dev, card, torch, np),
              30: lambda: wide_phase(dev, card, torch, np)}
    kernels = []
    for p in sorted(only):
        kernels += phases[p]()
        lap(p)
    return kernels


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    here = root = Path(__file__).resolve().parent
    modes = {"--k3-cells": k3_cells, "--k2-cells": k2_cells, "--k45-cells": k45_cells,
             "--k6-cells": k6_cells, "--k7-cells": k7_cells, "--k1-cells": k1_cells}
    mode = next((m for m in modes if m in sys.argv), None)
    if mode:
        root = Path(sys.argv[sys.argv.index(mode) + 1]).resolve()
    if not (root / "fiat_tpu_torch" / "__init__.py").is_file():
        fail(f"the fiat_tpu_torch package is not in {root}")
    sys.path.insert(0, str(root))

    import numpy as np
    from fiat_tpu_torch import ufc_simplex
    from fiat_tpu_torch.ops.kernels import load_kernels

    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)
    t0 = time.perf_counter()
    lib = load_kernels()
    print(f"build of {root}: {lib.path.relative_to(root)} in {time.perf_counter() - t0:.1f} s")
    print_ptxas(lib.build_log)
    if root == here:
        check_k2_sass(lib.path)
    if mode:
        modes[mode](dev, card, torch, np, own=root == here)
        return 0

    T = ufc_simplex(2)
    pts2 = make_points(NPTS, SEED, np)
    P = torch.as_tensor(pts2, device=dev)

    clock = [time.perf_counter()]

    def lap(phase):
        now = time.perf_counter()
        print(f"phase {phase} done in {now - clock[0]:.1f} s (wall clock)")
        clock[0] = now

    if "--phases" in sys.argv:
        # a quick check of some of the newest phases; the contract run takes
        # no arguments
        only = {int(p) for p in sys.argv[sys.argv.index("--phases") + 1].split(",")}
        print(json.dumps({"kernels": new_phases(dev, card, torch, np, lap, only)}))
        return 0

    slice_phase(T, dev, pts2, P, card, torch, np)
    lap(1)
    tab64, kernels, zoo_ms = full_zoo_phase(T, dev, pts2, P, card, torch, np)
    lap(2)
    ref64 = tab64(P)
    kernels += moments_phase(T, dev, pts2, P, card, torch, np)
    lap(3)
    kernels += f32_phase(T, dev, P, ref64, card, torch)
    lap(4)
    del ref64
    tet64, tet_kernels = tet_phase(dev, card, torch, np)
    kernels += tet_kernels
    lap(5)
    sv64, sv_kernels = sv_phase(dev, card, torch, np)
    kernels += sv_kernels
    lap(6)
    kernels += tet_dual_f32_phase(dev, card, tet64, torch, np)
    lap(7)
    kernels += tet_macro_phase(dev, card, sv64, torch, np)
    lap(8)
    kernels += c1_phase(T, dev, pts2, P, card, torch, np)
    lap(9)
    tet_engine = tet64["tet_lagrange8"]       # phase 26 holds its tables to this engine's
    zoo_engine = tab64                        # phase 27 maps its zany tables, 28 matches them
    del tab64, tet64, sv64
    kernels += zoo_phase([(sd, name, lambda sd=sd, specs=specs, comps=comps: families_zoo(
        specs, comps, ufc_simplex(sd))) for sd, name, specs, comps in (
            (2, "families_tri", FAMILIES_TRI, COMPOSITES_TRI),
            (3, "families_tet", FAMILIES_TET, COMPOSITES_TET))], dev, card, torch, np)
    lap("10-11")
    kernels += bench_tri_phase(T, dev, pts2, P, card, torch, np)
    lap(12)
    hex_gll_phase(dev, card, torch, np)
    lap(13)
    kernels += zoo_phase([(2, "stokes_elasticity_tri", lambda: stokes_zoo(2)),
                          (3, "stokes_elasticity_tet", lambda: stokes_zoo(3))],
                         dev, card, torch, np)
    lap("14-15")
    kernels += zoo_phase([(sd, name, lambda sd=sd, specs=specs: families_zoo(
        specs, (), ufc_simplex(sd))) for sd, name, specs in (
            (2, "split_variants_tri", SPLIT_TRI), (3, "split_variants_tet", SPLIT_TET))],
        dev, card, torch, np)
    lap("16-17")
    kernels += zoo_phase([(2, "iso_refined_tri", lambda: families_zoo(ISO_TRI, (), T))],
                         dev, card, torch, np)
    lap(18)
    kernels += zoo_phase([(sd, name, lambda sd=sd, spec=spec: families_zoo(
        (("Lagrange", 1, None), spec), (), ufc_simplex(sd))) for name, sd, spec in K3_WIDE],
        dev, card, torch, np)
    lap(19)
    kernels += interval_phase(dev, card, torch, np)
    lap(20)
    kernels += tp_phase(dev, card, torch, np)
    lap(21)
    kernels += new_phases(dev, card, torch, np, lap, tet_engine=tet_engine,
                          zoo_engine=zoo_engine, zoo_ms=zoo_ms)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
