"""fiat_tpu_torch: the PyTorch/CUDA port of fiat_tpu.

Host construction (cells, expansion sets, dual sets, nodal solves) is
float64 numpy/scipy, as in fiat_tpu.  Device tabulation runs eagerly on
torch tensors: hand-written CUDA kernels on the card (built from
``csrc/`` at first use by ``load_kernels``), their plain PyTorch versions
on the CPU.  Nothing here imports JAX.
"""

from fiat_tpu_torch.core import cells  # noqa: F401
from fiat_tpu_torch.core.cells import (  # noqa: F401
    TensorProductCell, UFCHexahedron, UFCQuadrilateral, default_simplex, symmetric_simplex,
    ufc_cell, ufc_simplex)
from fiat_tpu_torch.core.finite_element import (  # noqa: F401
    CiarletElement, FiniteElement, entity_support_dofs)
from fiat_tpu_torch.core.quadrature import make_quadrature  # noqa: F401
from fiat_tpu_torch.core.quadrature_schemes import create_quadrature  # noqa: F401
from fiat_tpu_torch.elements import *  # noqa: F401,F403
from fiat_tpu_torch.elements import extra_elements, supported_elements  # noqa: F401
from fiat_tpu_torch.ops import device_tabulator  # noqa: F401
from fiat_tpu_torch.ops.kernels import load_kernels  # noqa: F401

# subpackages re-exported as fiat_tpu's root re-exports them:
# fiat_tpu_torch.symbolic (the symbolic element layer), fiat_tpu_torch.ufl
# (element descriptions), fiat_tpu_torch.factory (descriptions -> symbolic
# elements)
from fiat_tpu_torch import symbolic  # noqa: E402,F401
from fiat_tpu_torch import ufl  # noqa: E402,F401
from fiat_tpu_torch.factory import (  # noqa: E402,F401
    as_fiat_cell, create_base_element, create_element)
