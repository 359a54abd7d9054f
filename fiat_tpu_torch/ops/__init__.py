"""Device tabulation engines.

``device_tabulator`` is the front door: it fuses a whole element zoo into
the kernel engine on the requested device.
"""


def device_tabulator(elements, order=0, f64=True, device=None):
    """The kernel engine (``fused_zoo.FusedZooTabulator``) for a zoo of
    nodal elements sharing a reference cell, plain and macro, tabulating
    derivatives up to ``order`` in float64 on ``device`` (CPU when None:
    the kernels' plain PyTorch versions; a CUDA device: the CUDA kernels).

    ``tab.block_tables(points)`` gives per-group float64 blocks and
    ``tab.unpack(blocks)`` the per-element dicts of ``el.tabulate``.

    Never returns a slower engine in place of the one asked for: what is
    not ported yet raises ``NotImplementedError``."""
    if not f64:
        raise NotImplementedError(
            "f64=False: the f32 throughput engine (TPU kernel K6, "
            "fiat_tpu/ops/pallas_tabulate.py) is not ported yet; ROADMAP.md, "
            "'TPU kernels to port', queues it after the moments kernels")
    from .fused_zoo import FusedZooTabulator
    from .tabulate import BatchedTabulator
    # the plain engine stays on the host: it only supplies the arrays
    return FusedZooTabulator(BatchedTabulator(elements, order=order), device=device)
