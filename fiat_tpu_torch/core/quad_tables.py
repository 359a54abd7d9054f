"""The generated quadrature tables, loaded by file path.

``fiat_tpu/core/{tri,tet,sym}quad_data.py`` are pure data (about 18.9k
lines, no imports): the port reads them where they lie instead of keeping
a second copy, without importing the ``fiat_tpu`` package.
"""

import functools
import importlib.util
from pathlib import Path

DATA_DIR = Path(__file__).resolve().parents[2] / "fiat_tpu" / "core"


@functools.lru_cache(maxsize=None)
def load_table(name):
    """The data module ``name`` (``triquad_data``, ``tetquad_data`` or
    ``symquad_data``), executed from its file."""
    path = DATA_DIR / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"fiat_tpu_torch.core._{name}", path)
    if spec is None or not path.is_file():
        raise FileNotFoundError(f"quadrature table {path} is missing")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module
