"""Device tabulation engines.

``device_tabulator`` is the front door: it fuses a whole element zoo into
the kernel engine on the requested device.
"""

#: fiat_tpu's keywords that only steer its TPU engines (point tile, the
#: Ozaki / native matmul, the MXU word type, Pallas interpret mode): taken
#: and ignored, so that fiat_tpu's callers run unchanged
TPU_ONLY = ("tile", "matmul", "wdtype", "interpret")


def device_tabulator(elements, order=0, f64=True, device=None, derivs="dmats", **tpu_only):
    """The kernel engine for a zoo of nodal elements sharing a reference
    cell, plain and macro, tabulating derivatives up to ``order`` on
    ``device``: the current CUDA card when None (raising without one), the
    CUDA kernels on a CUDA device, their plain PyTorch versions only where
    the caller asks for ``device="cpu"``.

    * ``f64=True``: ``fused_zoo.FusedZooTabulator`` in float64, on
      intervals, triangles and tetrahedra: K1 and K2, and for macro
      elements K3 (an interval parent, whatever its subcells, as
      fiat_tpu's one-shot route takes it; a triangle parent with at most
      32 subcells in all: a measured routing rule) or else K7
      (tetrahedra, and triangle zoos past 32 subcells; K7 has no interval
      stage), as each of ``tab.macro_routes``' ``.name`` says; both take
      programs of any number of subcells;
      ``tab.block_tables(points)`` gives per-group blocks and
      ``tab.unpack(blocks)`` the per-element dicts of ``el.tabulate``.
    * ``f64=False``: the f32 throughput engine ``f32_zoo.F32ZooTabulator``
      (K6, and K3 in float32 for macro elements: any number of subcells,
      in all and a program), on
      intervals, triangles and tetrahedra; ``tab.tables(points)`` gives the whole
      zoo's float32 tables.

    Macro programs that do not share the zoo's parent basis run by route
    (``fused_zoo.partition_macro_programs``, fiat_tpu's per-program
    fallback): K3 or K7 once per group of one Dubiner parent, K2 on the
    masked parent of a program on a variant parent.

    It takes fiat_tpu's keywords: ``derivs`` ("dmats", derivatives as
    change-of-basis rows on the order-0 recurrence, or "jets", the
    recurrence on Taylor jets; past order 0 fiat_tpu's engines key only
    the value table under "jets", since its ``alpha_mats`` is empty there,
    and so do the port's: K1 and K2 on the values, the macro elements'
    values on K3 or K7; any other value is a ``ValueError``), and
    ``tile``, ``matmul``, ``wdtype`` and ``interpret``, which steer
    fiat_tpu's TPU engines only and are ignored.  Any other keyword is a
    ``TypeError``.

    Never returns a slower engine in place of the one asked for: what is
    not ported raises ``NotImplementedError``."""
    unknown = sorted(set(tpu_only) - set(TPU_ONLY))
    if unknown:
        raise TypeError(f"device_tabulator() got unexpected keyword arguments {unknown}")
    if derivs not in ("dmats", "jets"):
        raise ValueError(f"derivs {derivs!r}: 'dmats' or 'jets'")
    from .kernels import resolve_device
    from .tabulate import BatchedTabulator
    device = resolve_device(device)
    # the plain engine stays on the host: it only supplies the arrays
    batched = BatchedTabulator(elements, order=order, device="cpu", derivs=derivs)
    if not f64:
        from .f32_zoo import F32ZooTabulator
        return F32ZooTabulator(batched, device=device)
    from .fused_zoo import FusedZooTabulator
    return FusedZooTabulator(batched, device=device)
