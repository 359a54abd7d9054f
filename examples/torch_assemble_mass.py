"""End-to-end example on fiat_tpu_torch: reference mass and stiffness
matrices on the CUDA card (the port's counterpart of assemble_mass.py).

1. describe the element (``fiat_tpu_torch.ufl``) and convert it
   (``create_element``; the factory's Lagrange default is spectral, so
   the description names the equispaced variant);
2. build a quadrature rule exact for products of gradients;
3. tabulate basis values and gradients at its points on the card
   (``ElementTabulator``: the hand-written recurrence and change-of-basis
   kernels, K1 + K2);
4. contract to the mass matrix  M_ij = sum_q w_q phi_i phi_j  and the
   stiffness matrix  K_ij = sum_q w_q grad phi_i . grad phi_j  with
   ``ir.contract`` (numpy's optimal contraction order, pairwise
   ``torch.einsum``), and read their cost with ``ir.cost_analysis``.

Run on a machine with a CUDA card:  python examples/torch_assemble_mass.py
On the CPU (the kernels' plain PyTorch versions):  ... --cpu
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import fiat_tpu_torch as ft  # noqa: E402
from fiat_tpu_torch import ir  # noqa: E402
from fiat_tpu_torch.ops.tabulate import ElementTabulator  # noqa: E402


def assemble(tab, points, weights):
    tables = tab(points)
    phi = tables[(0, 0)]                                      # (n, nq)
    grads = torch.stack([tables[(1, 0)], tables[(0, 1)]])    # (2, n, nq)
    M = ir.contract("iq,q,jq->ij", phi, weights, phi)
    K = ir.contract("kiq,q,kjq->ij", grads, weights, grads)
    return M, K, phi, grads


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--cpu", action="store_true",
                        help="run the kernels' plain PyTorch versions on the CPU")
    parser.add_argument("--degree", type=int, default=4)
    args = parser.parse_args()
    device = "cpu" if args.cpu else None        # None: the CUDA card, raising without one

    # 1. describe + convert
    desc = ft.ufl.FiniteElement("Lagrange", "triangle", args.degree, variant="equispaced")
    element = ft.create_element(desc).fiat_equivalent
    cell = element.get_reference_element()
    n = element.space_dimension()

    # 2. quadrature exact for products of gradients
    Q = ft.create_quadrature(cell, 2 * args.degree)

    # 3 + 4. tabulate on the device, contract
    tab = ElementTabulator(element, order=1, device=device)
    points = torch.as_tensor(Q.get_points(), device=tab.device)
    weights = torch.as_tensor(Q.get_weights(), device=tab.device)
    M, K, phi, grads = assemble(tab, points, weights)
    cost = ir.cost_analysis(lambda a, w: ir.contract("iq,q,jq->ij", a, w, a), phi, weights)
    M, K = M.cpu().numpy(), K.cpu().numpy()

    # sanity: the mass entries sum to the cell's volume; K annihilates constants
    print(f"element: {desc}  ({n} dofs) on {tab.device}")
    print(f"quadrature points: {len(Q.get_weights())}")
    print(f"sum(M) = {M.sum():.15f}  (cell volume = {cell.volume():.15f})")
    print(f"|K @ 1| = {np.abs(K @ np.ones(n)).max():.2e} (should be ~0)")
    print(f"cond(M) = {np.linalg.cond(M):.2e}")
    print(f"cost of M's contraction: {cost['flops']:.0f} flops, "
          f"{cost['bytes accessed']:.0f} bytes unfused")


if __name__ == "__main__":
    main()
