"""The tensor-IR layer: what plays gem's role in fiat_tpu_torch.

FInAT's stack builds an explicit tensor IR (gem, SURVEY.md section 2.3)
between the symbolic element layer and generated C code: hash-consed
expression DAGs, an optimiser (delta elimination, sum factorisation,
COFFEE refactorisation), a numpy interpreter, an imperative mini-language
(Impero) with a scheduler, and a static flop counter.

The port runs the symbolic layer eagerly on torch tensors, so gem is not
ported -- it is *substituted*, component by component, as
``fiat_tpu.ir`` substitutes it with jaxprs and XLA:

====================  ====================================================
gem component          fiat_tpu_torch / PyTorch equivalent
====================  ====================================================
Node framework         the aten graph of a traced function, a
(gem/node.py)          ``torch.fx.GraphModule`` (`as_graph` exposes the
                       DAG for inspection; fiat_tpu's ``as_jaxpr``)
IR node zoo            aten operators (add/mul/mm/bmm/sum/...); free
(gem/gem.py)           indices become tensor dimensions; IndexSum becomes
                       einsum/mm; ListTensor becomes stack
Optimiser              none behind eager torch; contraction ordering:
(gem/optimise.py)      `contract` (numpy's 'optimal' path applied pairwise,
                       the sum_factorise equivalent); delta elimination:
                       spectral identity-table shortcuts
                       (symbolic/spectral.py) and the dual-basis Kronecker
                       fast path (symbolic/base.py)
Refactoriser+COFFEE    not substituted (eager operators run as written)
Interpreter            `evaluate` below -- the function itself, eagerly on
(gem/interpreter.py)   a device (the card unless the caller names one)
Impero + scheduler     the graph's generated Python code (`lower_text`),
                       one aten call a line in execution order
Flop counter           `cost_analysis` below -- counted per aten operator
(gem/flop_count.py)    of the traced graph, plus analytic counts on the
                       kernel engines (chip_smoke.py's bounds)
Pretty printer         `pprint` below (the graph's readable listing)
sympy2gem              symbolic/sympy2array.py
====================  ====================================================

The hand-written CUDA kernels are launched through ``ctypes`` on raw
device pointers, so no trace can see them: `as_graph` traces on fake
tensors, where reading a pointer (or any value on the host) fails, and
raises `NotTraceable` rather than return a graph that lacks a launch.
The functions it serves are those of the symbolic tensor path, which are
plain torch.
"""

import numpy as np
import torch
from torch.overrides import TorchFunctionMode

from ..ops.kernels import resolve_device

__all__ = ("as_graph", "contract", "cost_analysis", "evaluate",
           "lower_text", "pprint")

#: the elementwise operators that XLA's cost model (fiat_tpu's) counts as
#: transcendentals rather than flops, by their aten names
TRANSCENDENTAL = frozenset(("exp", "expm1", "log", "log1p", "sigmoid", "pow", "sqrt", "rsqrt",
                            "tanh", "sin", "cos", "tan", "atan2", "erf"))

#: reductions, which count the elements read less the elements written
REDUCTIONS = frozenset(("sum", "mean", "prod", "amax", "amin", "max", "min"))


class NotTraceable(RuntimeError):
    """A function that `as_graph` cannot trace: it reads a tensor's memory
    on the host (a ctypes kernel launch's ``data_ptr()``, ``.item()``,
    ``.numpy()``, a branch on a tensor's value)."""


class _HostReads(TorchFunctionMode):
    """Raises `NotTraceable` where the traced function ``name`` reads a
    tensor's memory on the host: ``data_ptr()`` (every kernel wrapper's
    ctypes launch) or ``numpy()`` (``np.asarray`` of a tensor too)."""

    def __init__(self, name):
        super().__init__()
        self.name = name

    def __torch_function__(self, func, types, args=(), kwargs=None):
        if func is torch.Tensor.data_ptr:
            raise NotTraceable(
                f"as_graph: {self.name!r} reads a tensor's data_ptr(): the port's CUDA "
                "kernels are launched through ctypes on raw pointers and no trace can hold "
                "them; trace the plain torch functions (the symbolic tensor path), not the "
                "kernel engines")
        if func in (torch.Tensor.numpy, torch.Tensor.__array__):
            raise NotTraceable(f"as_graph: {self.name!r} copies a tensor to the host "
                               "(.numpy()); a traced graph holds no host read")
        return func(*args, **(kwargs or {}))


def _as_tensor(a, device=None):
    """A numpy argument as a tensor on ``device``; anything else as it is."""
    if isinstance(a, (np.ndarray, np.generic)):
        return torch.as_tensor(a, device=device)
    return a


def as_graph(fn, *example_args):
    """Trace ``fn`` on fake tensors shaped as ``example_args`` (numpy
    arguments become CPU tensors) and return its aten graph, a
    ``torch.fx.GraphModule`` -- the expression DAG that plays gem's Node
    graph role.  Calling it on real tensors of those shapes computes
    ``fn``.  Raises `NotTraceable` where ``fn`` reads a tensor's memory on
    the host: the port's hand-written kernels, launched through ``ctypes``
    on ``data_ptr()``, and data-dependent host reads."""
    from torch._subclasses.fake_tensor import (DataDependentOutputException,
                                               DynamicOutputShapeException)
    from torch.fx.experimental.proxy_tensor import make_fx
    from torch.fx.experimental.symbolic_shapes import GuardOnDataDependentSymNode

    args = [_as_tensor(a) for a in example_args]
    name = getattr(fn, "__name__", fn)

    def traced(*a):
        with _HostReads(name):
            return fn(*a)

    try:
        # through *args: make_fx would count a parameter with a default as an
        # input; tensors that fn holds (an element's or an engine's constant
        # tables) enter the graph as constants
        return make_fx(traced, tracing_mode="fake", _allow_non_fake_inputs=True)(*args)
    except (DataDependentOutputException, DynamicOutputShapeException,
            GuardOnDataDependentSymNode) as exc:
        raise NotTraceable(
            f"as_graph: {name!r} reads a tensor's value on the host "
            f"({type(exc).__name__}); a traced graph holds no data-dependent branch") from exc


def pprint(fn, *example_args):
    """The readable listing of ``fn``'s traced aten graph (gem/pprint.py
    equivalent)."""
    return as_graph(fn, *example_args).print_readable(print_output=False)


def lower_text(fn, *example_args):
    """The generated Python code of ``fn``'s traced graph, one aten call a
    line in execution order -- the scheduled imperative form that plays
    Impero's role (StableHLO's in fiat_tpu)."""
    return as_graph(fn, *example_args).code


def _product_flops(packet, args, kwargs, out):
    from torch.utils.flop_counter import flop_registry
    if packet in flop_registry:
        return flop_registry[packet](*args, **kwargs, out_val=out)
    name = packet.__name__
    if name == "mv":
        return 2 * args[0].shape[0] * args[0].shape[1]
    if name in ("dot", "vdot"):
        return 2 * args[0].shape[0]
    return None


def cost_analysis(fn, *example_args):
    """Static cost of ``fn`` (gem/flop_count.py equivalent): a dict with
    'flops', 'transcendentals' and 'bytes accessed', counted per aten
    operator of its traced graph (`as_graph`), as XLA's cost model counts
    fiat_tpu's HLO:

    * products (mm, addmm, bmm, baddbmm, mv, dot; einsum and matmul reach
      these) count 2 m n k;
    * elementwise arithmetic counts one flop for each result element, and
      the elementwise operators of TRANSCENDENTAL one transcendental each;
    * reductions count the elements read less the elements written (n - 1
      additions sum n elements);
    * bytes are the operands and results of every operator that moves
      data (views move none), unfused: each operator reads its inputs from
      memory and writes its results there, as no fusion is assumed.

    Nothing is computed: the graph is traced on fake tensors."""
    from torch.utils._pytree import tree_leaves, tree_map

    def fake(v):
        return v.meta.get("val") if isinstance(v, torch.fx.Node) else v

    def tensors(tree):
        return [t for t in tree_leaves(tree) if torch.is_tensor(t)]

    gm = as_graph(fn, *example_args)
    flops = transcendentals = nbytes = 0
    for node in gm.graph.nodes:
        if node.op != "call_function" or not isinstance(node.target, torch._ops.OpOverload):
            continue
        op, out = node.target, node.meta.get("val")
        name = op.overloadpacket.__name__.rstrip("_")
        args, kwargs = tree_map(fake, node.args), tree_map(fake, node.kwargs)
        ins, outs = tensors((args, kwargs)), tensors(out)
        product = _product_flops(op.overloadpacket, args, kwargs, out)
        if product is not None:
            flops += product
        elif name in REDUCTIONS:
            flops += sum(t.numel() for t in ins) - sum(t.numel() for t in outs)
        elif torch.Tag.pointwise in op.tags:
            count = sum(t.numel() for t in outs)
            if name in TRANSCENDENTAL:
                transcendentals += count
            else:
                flops += count
        # a constant's lift is the trace's, not a copy the eager call makes
        if not op.is_view and name != "lift_fresh_copy":
            nbytes += sum(t.numel() * t.element_size() for t in ins + outs)
    return {"flops": float(flops), "transcendentals": float(transcendentals),
            "bytes accessed": float(nbytes)}


def evaluate(fn, *args, device=None):
    """Evaluate ``fn`` eagerly on ``args`` (gem/interpreter.py equivalent):
    numpy arguments become tensors on ``device``, the CUDA card unless the
    caller names one (``device="cpu"``), as at every entry point of the
    port; tensors stay where they are."""
    dev = resolve_device(device)
    return fn(*[_as_tensor(a, dev) for a in args])


def _parse(subscripts, nops):
    """(input terms, output term) of explicit subscripts, the output of
    implicit ones numpy's (the letters seen once, sorted); None with an
    ellipsis."""
    inputs, arrow, output = subscripts.replace(" ", "").partition("->")
    terms = inputs.split(",")
    if "..." in subscripts or len(terms) != nops:
        return None
    if not arrow:
        letters = "".join(terms)
        output = "".join(sorted(c for c in set(letters) if letters.count(c) == 1))
    return terms, output


def contraction_path(subscripts, *operands, optimize="optimal"):
    """numpy's contraction path for ``subscripts`` on operands of these
    shapes (``np.einsum_path``'s first result); the operands may be
    tensors, arrays or shapes, and nothing is read of their values."""
    shapes = [tuple(getattr(a, "shape", a)) for a in operands]
    dummies = [np.broadcast_to(np.empty(()), s) for s in shapes]
    return np.einsum_path(subscripts, *dummies, optimize=optimize)[0]


def contract(subscripts, *operands, optimize="optimal", device=None):
    """Einsum with a flop-optimal contraction order -- the equivalent of
    gem's sum_factorise/associate ordering (gem/optimise.py:385): numpy's
    path (`contraction_path`, or ``optimize`` given as such a path) applied
    pairwise with ``torch.einsum``, each pair's result appended to the
    operands' end as numpy does.  (PyTorch's own ordering needs
    ``opt_einsum``, which cannot be relied on to be installed.)  numpy
    operands go to ``device`` where the caller names one, else to the
    first tensor operand's device, else to the CUDA card (``device="cpu"``
    for the CPU), as at every entry point of the port."""
    first = next((a.device for a in operands if torch.is_tensor(a)), None)
    dev = first if device is None and first is not None else resolve_device(device)
    ops = [_as_tensor(a, dev) for a in operands]
    parsed = _parse(subscripts, len(ops))
    if parsed is None or len(ops) < 3:
        return torch.einsum(subscripts, *ops)
    terms, output = parsed
    path = (optimize if isinstance(optimize, (list, tuple))
            else contraction_path(subscripts, *ops, optimize=optimize))
    for pair in path[1:]:
        picked = sorted(pair, reverse=True)
        parts = [(terms.pop(i), ops.pop(i)) for i in picked]
        keep = set(output).union(*terms)
        letters = "".join(t for t, _ in parts)
        result = "".join(dict.fromkeys(c for c in letters if c in keep))
        ops.append(torch.einsum(",".join(t for t, _ in parts) + "->" + result,
                                *[a for _, a in parts]))
        terms.append(result)
    return torch.einsum(f"{terms[0]}->{output}", ops[0])


def unconcatenate(pairs):
    """Split concatenation-valued assignments into per-chunk assignments
    (gem/unconcatenate.py:225's mixed-space splitting, in tensor form).

    ``pairs`` is a list of ((dest, slices), fused_tensor) where ``slices``
    is a list of (start, stop[, shape]) chunk descriptors along the fused
    tensor's leading axis.  Returns [((dest, k), chunk)] with chunks
    reshaped to their block shape when one is given."""
    out = []
    for (dest, slices), fused in pairs:
        for k, chunk in enumerate(slices):
            start, stop, *rest = chunk
            block = fused[start:stop]
            if rest and rest[0]:
                block = block.reshape(tuple(rest[0]) + tuple(block.shape[1:]))
            out.append(((dest, k), block))
    return out
