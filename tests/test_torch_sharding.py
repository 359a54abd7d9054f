"""The port's sharding layer (``fiat_tpu_torch.parallel.sharding``) on
torch.distributed against fiat_tpu's on a JAX mesh.

fiat_tpu runs its steps on ``points_mesh(4)`` and ``zoo_mesh(2, 2)`` of
the conftest's 8 CPU devices; the port runs every step in gloo worlds of
1, 2 and 4 spawned processes (``spawn_world``: each world joined with a
timeout and killed past it, so none can hang the suite), on the same
numpy inputs, and rank 0's gathered results are held to fiat_tpu's at
1e-12 relative to max(1, max |reference|).  The spawned ranks import
neither JAX nor fiat_tpu."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp

import fiat_tpu as jft
from fiat_tpu.ops.pallas_multiword import FusedZooTabulator as JFusedZooTabulator
from fiat_tpu.ops.tabulate import BatchedTabulator as JBatchedTabulator
from fiat_tpu.parallel import sharding as jsh
from fiat_tpu_torch.parallel import sharding as tsh

#: rank 0's gathered results against fiat_tpu's mesh steps, relative to
#: max(1, max |reference|)
RTOL = 1e-12
#: a spawned world's limit (the issue's 60 s); the worlds here take ~10 s
WORLD_TIMEOUT_S = 60
#: the dry run's zoo (__graft_entry__._flagship) and a macro element
SPEC = (2, tsh.FLAGSHIP[1] + [("HsiehCloughTocher", 3)])
NPTS = 10_000
FUSED_NPTS = 64
#: the 2-D mesh (points, rows) of each world
MESH_2D = {1: (1, 1), 2: (1, 2), 4: (2, 2)}


@pytest.fixture(scope="module")
def inputs():
    rng = np.random.default_rng(1)
    pts = rng.random((NPTS, 2)) * 0.5
    w = np.ones(NPTS) / NPTS
    f = rng.random(NPTS)
    zoo = tsh.build_zoo(SPEC, jft)
    rows = max(hi for _, hi, _ in JBatchedTabulator(zoo, order=0, matmul="native").slices)
    c = rng.random(rows) - 0.5
    return pts, w, f, c


@pytest.fixture(scope="module")
def reference(inputs):
    """fiat_tpu's steps on points_mesh(4) and zoo_mesh(2, 2)."""
    pts, w, f, c = inputs
    zoo = tsh.build_zoo(SPEC, jft)
    tab = JBatchedTabulator(zoo, order=0, matmul="native")
    mesh = jsh.points_mesh(4)
    pspec = jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("points"))
    spts = jsh.shard_points(jnp.asarray(pts), mesh)
    sw, sf = (jax.device_put(jnp.asarray(a), pspec) for a in (w, f))
    tables = jsh.sharded_tabulate(tab, pts, mesh)
    out = {"tabulate": {a: np.asarray(t) for a, t in tables.items()},
           "moments": np.asarray(jsh.make_moment_step(tab, mesh)(spts, sw, sf)),
           "interpolation": np.asarray(jsh.make_interpolation_step(tab, mesh)(
               spts, jnp.asarray(c)))}
    fz = JFusedZooTabulator(JBatchedTabulator(zoo, order=1, matmul="native"), interpret=True,
                            row_block=256, point_tile=128)
    blocks = jsh.make_fused_tabulate_step(fz, mesh)(
        jsh.shard_points(jnp.asarray(pts[:FUSED_NPTS]), mesh))
    out["fused"] = fz.unpack({a: [np.asarray(b) for b in bl] for a, bl in blocks.items()})
    mesh2 = jsh.zoo_mesh(2, 2)
    out["moments_2d"] = np.asarray(jsh.make_moment_step_2d(tab, mesh2)(
        jnp.asarray(pts), jnp.asarray(w), jnp.asarray(f)))
    return out


def _rel(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / max(1.0, float(np.abs(want).max()))


@pytest.mark.parametrize("n", [1, 2, 4])
def test_steps_in_a_gloo_world_match_fiat_tpu(n, inputs, reference):
    """Every step in a world of n spawned processes: tabulation,
    moments (one all-reduce), interpolation, the f64 kernel engine per
    rank (at order 1) and the 2-D moments, padded rows included."""
    pts, w, f, c = inputs
    results = tsh.spawn_world(n, tsh.run_steps,
                              (SPEC, pts, w, f, c, MESH_2D[n], pts[:FUSED_NPTS]),
                              timeout=WORLD_TIMEOUT_S)
    got, _ = results[0]
    assert all(r[0] is None for r in results[1:])
    assert set(got["tabulate"]) == set(reference["tabulate"])
    for a in reference["tabulate"]:
        assert _rel(got["tabulate"][a], reference["tabulate"][a]) <= RTOL
    assert _rel(got["moments"], reference["moments"]) <= RTOL
    assert _rel(got["interpolation"], reference["interpolation"]) <= RTOL
    for mine, ref in zip(got["fused"], reference["fused"]):
        assert set(mine) == set(ref)
        for a in ref:
            assert _rel(mine[a], np.asarray(ref[a]).reshape(mine[a].shape)) <= RTOL
    rows = len(reference["moments"])
    m2 = got["moments_2d"]
    nr = MESH_2D[n][1]
    assert len(m2) == -(-rows // nr) * nr and not np.any(m2[rows:])
    assert _rel(m2[:rows], reference["moments_2d"][:rows]) <= RTOL


def test_dryrun_in_four_processes():
    """``dryrun(4)``: the counterpart of __graft_entry__._dryrun_impl at
    16384 points, every check held to the unsharded engines."""
    errs = tsh.dryrun(4, timeout=WORLD_TIMEOUT_S)
    assert len(errs) == 4
    assert {"tabulate", "moments", "interpolation", "moments-2d",
            "moments-2d-macro"} <= set(errs[0])
    assert max(max(e.values()) for e in errs) < 1e-10


def test_a_failing_rank_fails_the_world():
    """``build_zoo(rank, n)`` takes no (rank, n): every rank raises, and
    the world raises with the first rank's traceback, its processes
    killed."""
    with pytest.raises(RuntimeError, match=r"rank \d failed(.|\n)*TypeError"):
        tsh.spawn_world(2, tsh.build_zoo, timeout=WORLD_TIMEOUT_S)


def test_a_group_refuses_tensors_its_backend_cannot_take(monkeypatch):
    """No step moves its work to another device: a CPU tensor in an NCCL
    group (or a CUDA one in an MPI group) raises instead."""
    import torch
    monkeypatch.setattr(tsh.dist, "get_backend", lambda group=None: "nccl")
    with pytest.raises(RuntimeError, match="cannot take cpu"):
        tsh.check_backend(torch.zeros(3), None)
    monkeypatch.setattr(tsh.dist, "get_backend", lambda group=None: "gloo")
    tsh.check_backend(torch.zeros(3), None)


def test_the_sharding_names_agree_with_fiat_tpu():
    """Every step and mesh of fiat_tpu's module is in the port's, beside
    the port's own helpers (shards, the gather, the spawned worlds)."""
    def names(mod):
        return {n for n, v in vars(mod).items()
                if not n.startswith("_") and callable(v)
                and getattr(v, "__module__", None) == mod.__name__}
    want = names(jsh)
    assert want == {"points_mesh", "shard_points", "sharded_tabulate", "make_moment_step",
                    "zoo_mesh", "make_moment_step_2d", "make_fused_tabulate_step",
                    "make_interpolation_step"}
    assert names(tsh) - want == {"mesh_device", "check_backend", "shard_bounds", "gather",
                                 "spawn_world", "dryrun", "build_zoo", "run_steps"}
    assert want <= names(tsh)
