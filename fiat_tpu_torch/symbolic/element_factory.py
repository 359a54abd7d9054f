"""Factory pass-through (parity with finat/element_factory.py and with
``fiat_tpu.symbolic.element_factory``): the conversion machinery lives in
``fiat_tpu_torch.factory``; re-exported here so symbolic-layer clients
find it in the same place as in FInAT.  Not imported by
``fiat_tpu_torch.symbolic.__init__`` (the factory imports the symbolic
package, so eager re-export would be circular)."""

from ..factory import (as_fiat_cell, convert,  # noqa: F401
                       create_base_element, create_element,
                       supported_elements)
