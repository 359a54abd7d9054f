"""Multi-process scaling for batched tabulation on torch.distributed.

Counterpart of ``fiat_tpu/parallel/sharding.py``.  The natural parallel
axis of this workload is the POINT batch: tabulation is embarrassingly
parallel over points, while moment contractions reduce over points and
need an all-reduce.  A mesh is a ``torch.distributed.device_mesh.
DeviceMesh`` over the ranks of the default process group, with the
dimension names ``("points",)`` or ``("points", "rows")``; every rank holds
its shard of the points as a plain tensor on its device, and every step
returns the rank's local result.  Each rank's work runs the port's
engines, so the kernels run per rank:

* ``points_mesh(n)``, ``shard_points(x, mesh)``: a 1-D mesh over "points"
  and the rank's contiguous shard of a point batch;
* ``sharded_tabulate``: any tabulator on the rank's shard (no
  communication);
* ``make_moment_step``: integral moments of every basis row of the zoo,
  K45 on the rank's shard then one ``all_reduce`` over "points";
* ``zoo_mesh``, ``make_moment_step_2d``: a (points x rows) mesh; the
  expansion-side sums (K4's and K5's functions, on K45) reduced over
  "points", then the rank's block of the nodal rows (padded to a multiple
  of the "rows" size) by one ``torch.matmul``, as fiat_tpu leaves that
  product to XLA;
* ``make_fused_tabulate_step``: the f64 kernel engine's ``block_tables``
  on the rank's shard (K1, K2 and K3 or K7);
* ``make_interpolation_step``: the transpose, ``interpolate_rows`` on the
  rank's shard (K1 and K3), no collective;
* ``gather``: the whole result from the ranks' shards, for checking;
* ``spawn_world`` and ``dryrun(n)``: a world of n spawned processes
  (rendezvous through a ``FileStore``, every group with a timeout, the
  world joined with one and killed past it), and in it one sharded
  assembly round trip held against the unsharded engines.

No step moves work to another device: a step's tensors stay where the
rank's shard is, and a group whose backend cannot take them raises (gloo
takes CPU and CUDA tensors, NCCL CUDA ones only).  On one card a world of
more than one process needs gloo (NCCL refuses two ranks on one device).
"""

import datetime
import os
import tempfile
import traceback

import numpy as np
import torch
import torch.distributed as dist

from ..ops.kernels import resolve_device

#: the device types each backend's collectives take
BACKEND_DEVICES = {"gloo": ("cpu", "cuda"), "nccl": ("cuda",), "mpi": ("cpu",)}
#: seconds a collective may wait for the other ranks, and a spawned world
#: may run, before it fails
GROUP_TIMEOUT_S = 60
WORLD_TIMEOUT_S = 300


def points_mesh(n_devices=None, devices=None, axis="points", device=None):
    """A 1-D mesh over the point-batch axis: the ranks ``devices`` (the
    first ``n_devices`` ranks of the default group, all of them when
    None), on the CUDA card unless ``device="cpu"``."""
    if devices is None:
        world = dist.get_world_size()
        devices = list(range(n_devices or world))
    return _device_mesh(resolve_device(device).type, np.asarray(devices), (axis,))


def zoo_mesh(n_points=None, n_rows=None, devices=None, axes=("points", "rows"), device=None):
    """A 2-D mesh: the point batch ('data parallel') axis times the
    basis-row ('tensor parallel') axis of the stacked zoo, over the ranks
    ``devices`` (the default group's when None)."""
    if devices is None:
        devices = list(range(dist.get_world_size()))
    if n_points is None or n_rows is None:
        n_rows = n_rows or 1
        n_points = n_points or len(devices) // n_rows
    ranks = np.asarray(devices[:n_points * n_rows]).reshape(n_points, n_rows)
    return _device_mesh(resolve_device(device).type, ranks, tuple(axes))


def _device_mesh(device_type, ranks, names):
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(device_type, torch.as_tensor(ranks, dtype=torch.int64),
                      mesh_dim_names=names)


def mesh_device(mesh):
    """The device a rank of ``mesh`` holds its shards on: its CUDA card
    (the current one) or the CPU."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def check_backend(tensor, group):
    """Raise unless ``group``'s backend takes tensors on ``tensor``'s
    device: a step never moves its work to another device to suit it."""
    backend = str(dist.get_backend(group)).lower()
    if tensor.device.type not in BACKEND_DEVICES.get(backend, ()):
        raise RuntimeError(
            f"a {backend} group cannot take {tensor.device.type} tensors (it takes "
            f"{BACKEND_DEVICES.get(backend, ())}); the step does not move them to another "
            "device: use a group whose backend takes them (gloo for several ranks on one card)")


def shard_bounds(npts, mesh, axis="points"):
    """(first, end) of this rank's contiguous shard of ``npts`` points
    along ``axis``: the sizes of ``torch.tensor_split``, which differ by
    at most one point."""
    n, r = mesh.size(mesh.mesh_dim_names.index(axis)), mesh.get_local_rank(axis)
    base, extra = divmod(npts, n)
    first = r * base + min(r, extra)
    return first, first + base + (r < extra)


def shard_points(points, mesh, axis="points"):
    """This rank's contiguous shard of a (npts, sd) point batch (or of
    any array along its leading axis), as a float64 tensor on the rank's
    device; a tensor elsewhere is refused."""
    dev = mesh_device(mesh)
    if isinstance(points, torch.Tensor) and points.device != dev:
        raise ValueError(f"points on {points.device}, the mesh's rank on {dev}")
    x = torch.as_tensor(points, dtype=torch.float64, device=dev)
    first, end = shard_bounds(x.shape[0], mesh, axis)
    return x[first:end].contiguous()


def sharded_tabulate(tabulator, points, mesh, axis="points"):
    """Tabulate the rank's shard: pure SPMD, no collectives; the tables
    come back sharded on their trailing (point) axis."""
    return tabulator(shard_points(points, mesh, axis))


def _moment_engine(tabulator):
    from ..ops.moments import moment_engine
    return moment_engine(tabulator)


def make_moment_step(tabulator, mesh, axis="points"):
    """An 'assembly step': ``step(points, weights, f_at_pts)`` on the
    rank's shards gives all moments M[i] = sum_q w_q phi_i(x_q) f(x_q) of
    every basis row of the zoo (macro elements included), the same on
    every rank: K45 on the rank's shard, then one ``all_reduce`` (SUM)
    over the "points" group.  ``step.collective_ms`` is the last
    all-reduce's time (``_timed``)."""
    eng = _moment_engine(tabulator)
    group = mesh.get_group(axis)

    def step(points, weights, f_at_pts):
        local = eng.moment_rows(points, eng._tensor(weights, "weights")
                                * eng._tensor(f_at_pts, "f_at_pts"))
        check_backend(local, group)
        step.collective_ms = _timed(lambda: dist.all_reduce(local, group=group), local)
        return local
    step.collective_ms = None
    step.engine = eng
    return step


def _timed(run, tensor):
    """Run a collective; its time in ms on the host's clock, the card (if
    ``tensor`` is on one) synchronized before and after."""
    import time
    if tensor.device.type == "cuda":
        torch.cuda.synchronize(tensor.device)
    t0 = time.perf_counter()
    run()
    if tensor.device.type == "cuda":
        torch.cuda.synchronize(tensor.device)
    return (time.perf_counter() - t0) * 1e3


def make_moment_step_2d(tabulator, mesh, axes=("points", "rows")):
    """Moments on a 2-D (points x rows) mesh: ``step(points, weights,
    f_at_pts)`` on the rank's point shard gives the rank's block of the
    moments (the rows of the zoo padded with zeros to a multiple of the
    "rows" size, that size's share each; entries past the zoo's rows are
    zero).  The expansion-side sums of the plain rows and every macro
    program (K4's and K5's functions, on K45) reduce over "points"; the
    nodal block matrix, its rows in the fused layout, is sharded over
    "rows" and applied by one ``torch.matmul``."""
    paxis, raxis = axes
    eng = _moment_engine(tabulator)
    pgroup = mesh.get_group(paxis)
    nr, r = mesh.size(mesh.mesh_dim_names.index(raxis)), mesh.get_local_rank(raxis)
    block = -(-eng.rows // nr)
    padded = torch.zeros((block * nr, eng.matrix.shape[1]), dtype=torch.float64,
                         device=eng.device)
    padded[:eng.rows] = eng.matrix
    mine = padded[r * block:(r + 1) * block].contiguous()

    def step(points, weights, f_at_pts):
        wfv = eng._tensor(weights, "weights") * eng._tensor(f_at_pts, "f_at_pts")
        vec = eng.sums(eng._tensor(points, "points"), wfv)
        check_backend(vec, pgroup)
        step.collective_ms = _timed(lambda: dist.all_reduce(vec, group=pgroup), vec)
        return mine @ vec
    step.collective_ms = None
    step.engine, step.rows_padded = eng, block * nr
    return step


def make_fused_tabulate_step(fused, mesh, axis="points"):
    """The f64 kernel engine (``fused_zoo.FusedZooTabulator``) on the
    rank's shard: ``step(points)`` gives its ``block_tables`` (K1, K2 and
    K3 or K7 per rank), sharded on their point axis; no collectives."""
    def step(points):
        return fused.block_tables(points)
    return step


def make_interpolation_step(tabulator, mesh, axis="points"):
    """The transpose direction: ``step(points, coefficients)`` evaluates
    the field of coefficients over every basis row of the zoo (macro
    elements included) at the rank's shard by ``interpolate_rows`` (K1
    and K3); no communication, the result stays point-sharded."""
    eng = _moment_engine(tabulator)

    def step(points, coefficients):
        return eng.interpolate_rows(points, coefficients)
    return step


def gather(local, mesh, axis="points", dim=-1):
    """The whole result from every rank's shard along ``dim`` (the point
    axis), on every rank of the ``axis`` group, on the rank's device: a
    checking helper, which sends the shards through the CPU whatever the
    backend (shards may differ by one point)."""
    group = mesh.get_group(axis)
    host = local.detach().to("cpu").contiguous()
    n = dist.get_world_size(group)
    sizes = [None] * n
    dist.all_gather_object(sizes, tuple(host.shape), group=group)
    width = max(s[dim] for s in sizes)
    pad = [0, 0] * host.dim()
    pad[2 * (host.dim() - 1 - (dim % host.dim())) + 1] = width - host.shape[dim]
    padded = torch.nn.functional.pad(host, pad)
    parts = [torch.empty_like(padded) for _ in range(n)]
    if str(dist.get_backend(group)).lower() != "gloo":
        # NCCL gathers on the card: the CPU copy goes back for the call
        parts = [p.to(local.device) for p in parts]
        padded = padded.to(local.device)
    dist.all_gather(parts, padded, group=group)
    parts = [p.narrow(dim, 0, s[dim]).to(local.device) for p, s in zip(parts, sizes)]
    return torch.cat(parts, dim=dim)


# -- spawned worlds -------------------------------------------------------------------

def _world_main(rank, n, backend, store_path, device, fn, args, results):
    """One rank of a spawned world: join the group through the FileStore,
    run ``fn(rank, n, *args)``, put (rank, result or traceback)."""
    try:
        if device == "cuda":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        store = dist.FileStore(store_path, n)
        dist.init_process_group(backend, store=store, rank=rank, world_size=n,
                                timeout=datetime.timedelta(seconds=GROUP_TIMEOUT_S))
        try:
            out = fn(rank, n, *args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:                  # noqa: BLE001 - reported to the parent
        results.put((rank, False, traceback.format_exc()))


def spawn_world(n, fn, args=(), backend="gloo", timeout=WORLD_TIMEOUT_S, device="cpu"):
    """Run ``fn(rank, n, *args)`` in a world of ``n`` spawned processes on
    ``backend`` (every group with a ``GROUP_TIMEOUT_S`` timeout, the
    rendezvous through a ``FileStore`` in a temporary directory, no
    network); returns the ranks' results in rank order.  ``fn`` must be
    importable (a module-level function) and its results picklable.  A
    world that is not done within ``timeout`` seconds, or a rank that
    fails, raises ``RuntimeError`` after every process is killed.
    ``device="cuda"`` sets each rank's current card (rank modulo the
    cards) for ``fn``."""
    import multiprocessing as mp
    import queue
    import time

    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with tempfile.TemporaryDirectory(prefix="fiat_tpu_torch_world_") as tmp:
        store = os.path.join(tmp, "store")
        procs = [ctx.Process(target=_world_main,
                             args=(r, n, backend, store, device, fn, args, results), daemon=True)
                 for r in range(n)]
        for p in procs:
            p.start()
        out, deadline = {}, time.monotonic() + timeout
        try:
            while len(out) < n:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise RuntimeError(f"spawn_world({n}): not done in {timeout} s")
                try:
                    rank, ok, value = results.get(timeout=min(left, 1.0))
                except queue.Empty:
                    dead = [p for p in procs if p.exitcode not in (None, 0)]
                    if dead:
                        raise RuntimeError(f"spawn_world({n}): a rank exited with "
                                           f"{dead[0].exitcode} and reported nothing")
                    continue
                if not ok:
                    raise RuntimeError(f"spawn_world({n}): rank {rank} failed:\n{value}")
                out[rank] = value
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join(5)
    return [out[r] for r in range(n)]


# -- the dry run ----------------------------------------------------------------------

#: the dry run's zoo (``__graft_entry__._flagship``), for ``build_zoo``:
#: Lagrange 1-4, Raviart-Thomas 2 and Nedelec 2 on the triangle
FLAGSHIP = (2, [("Lagrange", 1), ("Lagrange", 2), ("Lagrange", 3), ("Lagrange", 4),
                ("RaviartThomas", 2), ("Nedelec", 2)])


def _dryrun_rank(rank, n, device):
    """One rank of ``dryrun``: every step on the rank's shards, each held
    to the unsharded engines over the whole batch (on every rank, the same
    numbers), relative to max(1, max |reference|)."""
    from ..ops import device_tabulator
    from ..ops.moments import moment_rows
    from ..ops.tabulate import BatchedTabulator

    def check(name, got, want, tol):
        got, want = got.double().cpu(), want.double().cpu()
        err = (got - want).abs().max().item() / max(want.abs().max().item(), 1.0)
        if not err < tol:
            raise AssertionError(f"{name}: sharded vs unsharded {err:.2e} >= {tol}")
        return err

    errs = {}
    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    zoo = build_zoo(FLAGSHIP)
    tab = BatchedTabulator(zoo, order=0, device=dev)
    mesh = points_mesh(n, device=device)
    rng = np.random.default_rng(1)
    npts = max(16384 // n, 16) * n                         # a realistic size
    hpts = rng.random((npts, 2)) * 0.5
    hw = np.ones(npts) / npts
    hf = rng.random(npts)
    pts, w, f = (shard_points(a, mesh) for a in (hpts, hw, hf))

    phi = tab(hpts)[(0, 0)]
    # tabulation on the f64 kernel engine (K1, K2, K3), held to the plain
    # tabulator's tables
    tables = sharded_tabulate(device_tabulator(zoo, order=0, device=dev), hpts, mesh)
    errs["tabulate"] = check("tabulate", gather(tables[(0, 0)], mesh), phi, 1e-10)

    moments = make_moment_step(tab, mesh)(pts, w, f)
    want_m = phi @ torch.as_tensor(hw * hf, device=dev)
    errs["moments"] = check("moments", moments, want_m, 1e-12)
    vals = make_interpolation_step(tab, mesh)(pts, moments)
    errs["interpolation"] = check("interpolation", gather(vals, mesh), moments @ phi, 1e-12)

    # the f64 kernel engine per rank, at order 1, held to the host tables
    fz = device_tabulator(zoo, order=1, device=dev)
    small = shard_points(hpts[:16 * n], mesh)
    blocks = make_fused_tabulate_step(fz, mesh)(small)
    per = fz.unpack({a: [gather(b, mesh) for b in bl] for a, bl in blocks.items()})
    for el, mine in zip(zoo, per):
        ref = el.tabulate(1, hpts[:16 * n])
        for a, t in ref.items():
            errs[f"fused {type(el).__name__} {a}"] = check(
                f"fused {type(el).__name__} {a}", mine[a],
                torch.as_tensor(np.asarray(t)).reshape(mine[a].shape), 1e-10)

    if n % 2 == 0:
        mesh2 = zoo_mesh(n_points=n // 2, n_rows=2, device=device)
        for name, z in (("moments-2d", zoo),
                        ("moments-2d-macro", build_zoo(
                            (2, [("Lagrange", 2), ("HsiehCloughTocher", 3)])))):
            bt = tab if z is zoo else BatchedTabulator(z, order=0, device=dev)
            p2, w2, f2 = (shard_points(a, mesh2) for a in (hpts, hw, hf))
            step2 = make_moment_step_2d(bt, mesh2)
            mine = step2(p2, w2, f2)
            whole = gather(mine, mesh2, axis="rows", dim=0)[:step2.engine.rows]
            want = moment_rows(bt, torch.as_tensor(hpts, device=dev),
                               torch.as_tensor(hw * hf, device=dev))
            errs[name] = check(name, whole, want, 1e-12)
    return errs


def dryrun(n, device="cpu", backend="gloo", timeout=WORLD_TIMEOUT_S):
    """Validate the sharded path in a world of ``n`` spawned processes
    (gloo on the CPU by default), the counterpart of
    ``__graft_entry__._dryrun_impl``: sharded tabulation (on the f64
    kernel engine), 1-D moments with an all-reduce, the interpolation
    transpose and the f64 kernel engine per rank at >= 1e4 points, and,
    when ``n`` is even, the 2-D (points x
    rows) moments, also with a macro element; every result held to the
    unsharded engines.  Returns each rank's {check: error}; raises on a
    failed check, a failed rank or a world past ``timeout``."""
    return spawn_world(n, _dryrun_rank, (device,), backend=backend, timeout=timeout,
                       device=device)



def build_zoo(spec, ns=None):
    """The elements of ``spec`` = (sd, [(family, degree), ...]) on the UFC
    simplex of dimension sd, from the namespace ``ns`` (this package when
    None): a picklable description of a zoo for a spawned world."""
    if ns is None:
        import fiat_tpu_torch as ns
    sd, members = spec
    T = ns.ufc_simplex(sd)
    return [getattr(ns, family)(T, degree) for family, degree in members]


def run_steps(rank, n, spec, points, weights, f_at_pts, coefficients, mesh_2d=None,
              fused_points=None, device="cpu"):
    """Every step once in the current world, on the zoo of ``spec``
    (``build_zoo``) and the whole batch given to every rank, each rank
    taking its shards: ``sharded_tabulate`` on the f64 kernel engine at
    order 0 and the interpolation step (gathered), the 1-D moment step,
    the f64 kernel engine's step at order 1 on ``fused_points`` (per
    element, gathered), and on the (points, rows)
    mesh ``mesh_2d`` the 2-D moment step (gathered over "rows").  Returns
    rank 0's numpy results (None on the other ranks) and every rank's
    kernel launches, {step: {kernel: launches}}."""
    from ..ops import device_tabulator
    from ..ops.tabulate import BatchedTabulator

    dev = resolve_device(device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    zoo = build_zoo(spec)
    tab = BatchedTabulator(zoo, order=0, device=dev)
    mesh = points_mesh(n, device=device)
    pts, w, f = (shard_points(a, mesh) for a in (points, weights, f_at_pts))
    out, launches = {}, {}
    eng = _moment_engine(tab)

    def counted(name, kernels, run):
        for k in kernels.values():
            k.launches = 0
        res = run()
        launches[name] = {k: v.launches for k, v in kernels.items()}
        return res

    fz0 = device_tabulator(zoo, order=0, device=dev)
    tables = counted("tabulate", _engine_kernels(fz0),
                     lambda: sharded_tabulate(fz0, points, mesh))
    out["tabulate"] = {a: gather(t, mesh) for a, t in tables.items()}
    moments = counted("moments", {"K45": eng.moments},
                      lambda: make_moment_step(tab, mesh)(pts, w, f))
    out["moments"] = moments
    interp = make_interpolation_step(tab, mesh)
    vals = counted("interpolation", {"K1": eng.recurrence, **{
        f"K3 route {k}": mo for k, mo in enumerate(eng.macros)}}, lambda: interp(pts, coefficients))
    out["interpolation"] = gather(vals, mesh)
    fz = device_tabulator(zoo, order=1, device=dev)
    small = shard_points(points if fused_points is None else fused_points, mesh)
    blocks = counted("fused", _engine_kernels(fz),
                     lambda: make_fused_tabulate_step(fz, mesh)(small))
    out["fused"] = fz.unpack({a: [gather(b, mesh) for b in bl] for a, bl in blocks.items()})
    if mesh_2d is not None:
        mesh2 = zoo_mesh(*mesh_2d, device=device)
        step2 = make_moment_step_2d(tab, mesh2)
        p2, w2, f2 = (shard_points(a, mesh2) for a in (points, weights, f_at_pts))
        mine = counted("moments_2d", {"K45": eng.moments}, lambda: step2(p2, w2, f2))
        out["moments_2d"] = gather(mine, mesh2, axis="rows", dim=0)
    if rank != 0:
        return None, launches
    return _to_numpy(out), launches


def _engine_kernels(fused):
    """{name: wrapper} of the f64 kernel engine's kernels: K1, K2 and each
    macro route's."""
    kernels = {"K1": fused.recurrence, "K2": fused.matmul}
    kernels.update({f"{r.name} route {k}": r.engine for k, r in enumerate(fused.macro_routes)})
    return kernels


def _to_numpy(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, dict):
        return {k: _to_numpy(v) for k, v in x.items()}
    if isinstance(x, list):
        return [_to_numpy(v) for v in x]
    return x
