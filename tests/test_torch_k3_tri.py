"""K3 on triangles (``ops/macro_oneshot.MacroOneShot`` on a triangle parent)
in its row-chunked layout, against fiat_tpu on the CPU: a replay of the
kernel's loop on the slice tables the wrapper builds (one chunk a group for
the tables, every program's one-row chunk in one group for the
interpolation's W; resident slices or a streaming ring, under the plan and
under narrow ones), the plan that fits only the Phi tile and a ring of
slices in a block, and the C1 zoo at order 3, whose A (330 x 138) is past a
block's shared memory, against fiat_tpu's host tabulation and its one-shot
kernel ``FusedMacroOneShot`` in interpret mode.

Inputs are numpy arrays made from seeds and handed to both packages;
fiat_tpu's Pallas kernels run in interpret mode, as its own tests run
them."""

import math
import os
import sys

import numpy as np
import pytest
import torch
import jax
import jax.numpy as jnp

from fiat_tpu import elements as jfe
from fiat_tpu.core import cells as jcl
from fiat_tpu.ops import moments as jmo
from fiat_tpu.ops.pallas_multiword import FusedMacroOneShot
from fiat_tpu.ops.tabulate import BatchedTabulator as JBatchedTabulator
from fiat_tpu_torch import device_tabulator
from fiat_tpu_torch import elements as tfe
from fiat_tpu_torch.core import cells as tcl
from fiat_tpu_torch.core import macro as tmacro
from fiat_tpu_torch.ops import moments as tmo
from fiat_tpu_torch.ops.fused_zoo import _merge_macro_programs
from fiat_tpu_torch.ops.macro_oneshot import (CHUNK_ROWS, FIRST_IN_CHUNK, LAST_IN_CHUNK,
                                              MAX_SMEM, ONE_ROW_CHUNK, RESIDENT_SMEM, MacroOneShot,
                                              ceil16, column_stride, smem_bytes,
                                              tiles_per_block)
from fiat_tpu_torch.ops.tabulate import BatchedTabulator
from chip_smoke import merged_macro

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
from test_torch_macro import _points, _special_points  # noqa: E402
from test_torch_macro_tet import _bin_as_the_kernel  # noqa: E402
from test_torch_recurrence import (_dubiner1_point,  # noqa: E402
                                   _dubiner2_point)
from test_torch_tet_dual import _dubiner3_values  # noqa: E402

RTOL_REPLAY = 1e-13     # the kernel's loop vs the plain version: the order of sums differs
RTOL_INTERPRET = 1e-5   # fiat_tpu's one-shot kernel in interpret mode (its own CPU bar)
ATOL_HOST = 1e-10       # f64 tables vs host el.tabulate (the BASELINE.json metric)
ATOL_PS12_9 = 1e-6      # Lagrange 9 on PS12: tables vs fiat_tpu's (3.1e-7), u vs c @ tables (2.5e-7)
ROW_GROUP = 8           # rows the kernel skips at a time past a chunk's last (csrc ROW_GROUP)


def _full_zoo_macro(fe, T):
    """full_zoo's macro elements (HCT 3 and PS6) beside a plain one."""
    return [fe.Lagrange(T, 3), fe.HsiehCloughTocher(T, 3), fe.QuadraticPowellSabin6(T)]


def _c1_zoo(fe, T):
    """bench.py's c1_macro_zoo (:825-837): the C1 elements plus PS6 and PS12."""
    return [fe.CubicHermite(T), fe.Morley(T), fe.Argyris(T, 5), fe.Bell(T),
            fe.HsiehCloughTocher(T, 3), fe.QuadraticPowellSabin6(T),
            fe.QuadraticPowellSabin12(T)]


ZOOS = {"full_zoo_macro": _full_zoo_macro, "c1_macro_zoo": _c1_zoo}


def _k3(zoo, order, dtype=torch.float64):
    """K3 on the merged macro programs of a port zoo (the CPU: its plain
    version)."""
    st = BatchedTabulator(zoo, order=order, device="cpu").state()
    merged = _merge_macro_programs(st["macro_programs"], st["scale"], st["affine_map"], order)
    return MacroOneShot(**merged, device="cpu", dtype=dtype)


def _rule_words(hits, unique):
    """binning.cuh's rule_word over a program's words of 32 pieces, in
    order: (kept hits, hits kept a point)."""
    kept, out = np.zeros(len(hits), int), np.zeros_like(hits)
    for w0 in range(0, hits.shape[1], 32):
        bits = hits[:, w0:w0 + 32].copy()
        if unique:      # the word's first hit, if no word before had one
            bits &= (np.cumsum(bits, axis=1) == 1) & (kept == 0)[:, None]
        kept += bits.sum(axis=1)
        out[:, w0:w0 + 32] = bits
    return out, kept


def _replay_k3(mo, pts, A=None, sub=None):
    """csrc/macro_oneshot.cuh's loop in numpy on the tables the wrapper
    built for its plan (``mo.layout``), on intervals, triangles or
    tetrahedra.  Per
    block, its group of chunks (one for the tables, every program's one-row
    chunk for ``A``) and ``sub`` point tiles of the plan's points (the
    wrapper's count unless given): the shared memory as the bulk copies fill
    it (every slice of the group at its offset from the group's first, or
    the ring's buffers, visit u's slice into buffer u % stages once visit u
    - stages is done; whatever no copy writes is NaN here); per tile the
    recurrence's values (dubiner1.cuh, dubiner2.cuh or dubiner3.cuh); per
    chunk its
    program's binning word by word; per slice, for each hit piece in order,
    k ascending, phi_k times its column into the chunk's rows, a group of
    ROW_GROUP rows at a time up to the chunk's last row."""
    maps, progs, pieces = mo.maps.numpy(), mo.progs.numpy(), mo.pieces.numpy()
    consts, slots = mo.consts.numpy(), mo.slots.numpy()
    one = A is not None
    lay = mo.layout(one)
    tp, _, stages, resident = mo.plan_one if one else mo.plan
    rc = ONE_ROW_CHUNK if one else CHUNK_ROWS
    rcp, group = column_stride(rc), min(rc, ROW_GROUP)
    A = mo.A.numpy() if A is None else A
    At = np.append(A.ravel(), 0.0)[lay["gather"]]
    slices, groups, buf = lay["slices"], lay["groups"], lay["buf"]
    sd = mo.sd
    ref = (pts @ mo.affine[:sd * sd].reshape(sd, sd).T + mo.affine[sd * sd:]).T
    if sd == 1:
        phi = _dubiner1_point(ref[0], consts, mo.degree, mo.scale)
    elif sd == 2:
        phi = _dubiner2_point(ref[0], ref[1], consts, slots, mo.degree, mo.scale)
    else:
        phi = np.zeros((math.comb(mo.degree + 3, 3), len(pts)))
        for e, v in _dubiner3_values(ref, consts, mo.degree, mo.scale):
            phi[slots[e]] = v
    npts = len(pts)
    ntiles = -(-npts // tp)
    sub = sub or tiles_per_block(npts, len(groups) - 1, tp)
    out = np.full((A.shape[0], npts), np.nan)
    for first, end in zip(groups[:-1], groups[1:]):
        n, base = end - first, slices[first, 5]
        for tile0 in range(0, ntiles, sub):
            tiles = min(sub, ntiles - tile0)
            smem = np.full(lay["ring"], np.nan)

            def fetch(t, at):
                off, size = slices[first + t, 5], slices[first + t, 8]
                assert at + size <= len(smem) and off % (16 // At.itemsize) == 0
                smem[at:at + size] = At[off:off + size]

            if resident:
                for t in range(n):
                    fetch(t, slices[first + t, 5] - base)
            else:
                for u in range(min(stages, tiles * n)):
                    fetch(u % n, u * buf)
            for s in range(tiles):
                q = np.arange((tile0 + s) * tp, min((tile0 + s + 1) * tp, npts))
                for t in range(n):
                    u = s * n + t
                    g, row0, nrows, k0, k1, off, npieces, flags, _, c0, unique = slices[first + t]
                    assert (c0, c0 + npieces, unique) == tuple(progs[g, 2:])
                    if flags & FIRST_IN_CHUNK:
                        hits, kept = _rule_words(
                            _bin_as_the_kernel(maps, pts[q], c0, c0 + npieces), unique)
                        with np.errstate(divide="ignore"):
                            recip = 1.0 if unique else 1.0 / kept
                        live = min(rc, -(-nrows // group) * group)
                        acc = np.zeros((live, len(q)))
                    at = off - base if resident else (u % stages) * buf
                    cols = smem[at:at + (k1 - k0) * npieces * rcp].reshape(k1 - k0, npieces, rcp)
                    for j in range(npieces):
                        for k in range(k0, min(pieces[c0 + j, 1], k1)):
                            acc += np.where(hits[:, j], cols[k - k0, j, :live, None] * phi[k, q],
                                            0.0)
                    if not resident and u + stages < tiles * n:
                        fetch((u + stages) % n, (u % stages) * buf)
                    if flags & LAST_IN_CHUNK:
                        out[row0:row0 + nrows, q] = (acc * recip)[:nrows]
    return out


@pytest.mark.parametrize("where", ["random", "tie"])
@pytest.mark.parametrize("order", [0, 1])
@pytest.mark.parametrize("zoo", sorted(ZOOS))
def test_k3_tri_kernel_loop_on_its_chunk_table_matches_plain(zoo, order, where):
    """The kernel cannot run here: its loop, replayed on the chunk tables,
    the packed constants and the shared-memory offsets the wrapper built,
    equals the plain version, on random points and on points where subcells
    meet (the first hit of each C0 program at order 0, 1 / hits elsewhere),
    for the merged tables and for one row per program (the interpolation's
    W)."""
    mo = _k3(ZOOS[zoo](tfe, tcl.ufc_simplex(2)), order)
    assert mo.sd == 2 and mo.cpb == 1 and mo.cpb_one == len(mo.geom)
    pts = _points(150, 40 + order) if where == "random" else _special_points()
    P = torch.as_tensor(pts)
    want = mo(P).numpy()
    assert np.abs(_replay_k3(mo, pts) - want).max() <= RTOL_REPLAY * np.abs(want).max()
    # a streaming ring of one k of the widest program a slice, blocks of
    # three tiles of 64 points (the ring's visits run on across tiles)
    widest = int((mo.progs[:, 3] - mo.progs[:, 2]).max())
    mo.plan = (mo.tp, widest, 2, False)
    assert np.abs(_replay_k3(mo, pts, sub=3) - want).max() <= RTOL_REPLAY * np.abs(want).max()
    # row g of W holds program g's columns alone, as the interpolation's does
    W = np.random.default_rng(order).standard_normal((len(mo.geom), mo.K))
    W *= np.repeat(np.eye(len(mo.geom)), [sum(mo.nexp[c0:c1]) for _, _, c0, c1, _ in
                                          mo.progs.numpy()], axis=1)
    want = mo(P, A=torch.as_tensor(W)).numpy()
    assert np.abs(_replay_k3(mo, pts, W) - want).max() <= RTOL_REPLAY * np.abs(want).max()


@pytest.mark.parametrize("order,rows,chunks", [
    (1, (36, 27), [[0, 0, 32, 10], [0, 32, 4, 10], [1, 36, 27, 6]]),
    (2, (72, 54, 72), [[0, 0, 32, 10], [0, 32, 32, 10], [0, 64, 8, 10], [1, 72, 32, 6],
                       [1, 104, 22, 6], [2, 126, 32, 6], [2, 158, 32, 6], [2, 190, 8, 6]])])
def test_k3_tri_chunk_tables(order, rows, chunks):
    """full_zoo's macro programs at order 1 (HCT 36 rows, PS6 27) and the C1
    zoo's at order 2 (HCT 72, PS6 54, PS12 72): 32-row chunks with the
    program's widest piece; the plan keeps each chunk resident at 128
    points (one slice a chunk, its P x kw columns of 34 values padded to 16
    bytes), and one-row chunks all in one group, resident too."""
    zoo = (_full_zoo_macro if order == 1 else _c1_zoo)(tfe, tcl.ufc_simplex(2))
    mo = _k3(zoo, order)
    assert [r1 - r0 for r0, r1 in (g["rows"] for g in mo.geom)] == list(rows)
    assert mo.chunks.tolist() == chunks
    npieces = [3, 6, 12][:len(rows)]
    widths = [10, 6, 6][:len(rows)]
    cols = [p * w for p, w in zip(npieces, widths)]
    assert mo.plan == (128, max(cols), 1, True) and mo.plan_one == (128, max(cols), len(rows),
                                                                    True)
    lay = mo.layout()
    assert lay["slices"][:, 8].tolist() == [cols[g] * column_stride(CHUNK_ROWS) for g, *_ in chunks]
    assert lay["ring"] == max(cols) * column_stride(CHUNK_ROWS) and lay["nbar"] == 0
    assert mo.smem == smem_bytes(10, 8, 128, lay["ring"], 1, 0)
    one = mo.layout(one=True)
    assert mo.chunks_one.tolist() == [[g, g, 1, w] for g, w in enumerate(widths)]
    assert one["ring"] == sum(ceil16(8 * c) // 8 for c in cols) < lay["ring"]
    assert one["groups"].tolist() == [0, len(rows)]
    assert mo.smem_one == smem_bytes(10, 8, 128, one["ring"], 1, 0)


def test_k3_tri_takes_an_a_past_shared_memory():
    """The C1 zoo at order 3: K3's A (330 x 138, 355.8 KB in f64) is past a
    block's 227 KB, which only a row chunk and the Phi tile must fit; so is
    a program 4000 rows tall."""
    mo = _k3(_c1_zoo(tfe, tcl.ufc_simplex(2)), 3)
    assert (mo.rows, mo.K) == (330, 138) and mo.rows * mo.K * 8 > MAX_SMEM
    assert mo.smem <= MAX_SMEM and mo.chunks.shape[0] == 11 and mo.plan[3]
    split = tmacro.PowellSabin12Split(tcl.ufc_simplex(2))
    tall = MacroOneShot(A=np.ones((4000, 12 * 10)), pieces=[(c, 10) for c in range(12)],
                        geom=[{"maps": [split.barycentric_map(entity=(2, c), rescale=True)
                                        for c in range(12)], "unique": False, "rows": (0, 4000)}],
                        parent_map=tcl.ufc_simplex(2).barycentric_map(rescale=True), degree=3,
                        scale=1.0, affine_map=(2 * np.eye(2), -np.ones(2)), device="cpu")
    assert tall.chunks.shape[0] == 125 and tall.smem <= MAX_SMEM
    assert len(tall.layout()["groups"]) == 126


@pytest.mark.parametrize("dtype,subcells,degree,fits", [
    (torch.float64, 3, 10, True), (torch.float64, 6, 10, True), (torch.float64, 12, 8, True),
    (torch.float64, 12, 9, False), (torch.float32, 12, 10, True)])
def test_k3_tri_streams_only_a_chunk_and_tile_past_shared_memory(dtype, subcells, degree, fits):
    """One triangle program of ``subcells`` pieces of the degree's width, 40
    rows: its chunk (subcells x n x 34 values) and the Phi tile (n x 128)
    fit a block's 227 KB, or not (``fits``: the shapes the kernel refused
    before).  The plan keeps the chunk resident where the block takes at
    most a quarter of an SM's shared memory (RESIDENT_SMEM), and else
    streams it through a ring of slices at 128 points.  Every plan fits a
    block, and the kernel's loop under it equals the plain version."""
    split = {3: tmacro.AlfeldSplit, 6: tmacro.PowellSabinSplit,
             12: tmacro.PowellSabin12Split}[subcells](tcl.ufc_simplex(2))
    n = (degree + 1) * (degree + 2) // 2
    rng = np.random.default_rng(degree)
    args = dict(A=rng.standard_normal((40, subcells * n)),
                pieces=[(c, n) for c in range(subcells)],
                geom=[{"maps": [split.barycentric_map(entity=(2, c), rescale=True)
                                for c in range(subcells)], "unique": False, "rows": (0, 40)}],
                parent_map=tcl.ufc_simplex(2).barycentric_map(rescale=True), degree=degree,
                scale=1.0, affine_map=(2 * np.eye(2), -np.ones(2)), device="cpu", dtype=dtype)
    size = 8 if dtype == torch.float64 else 4
    whole = ceil16(subcells * n * column_stride(CHUNK_ROWS) * size) + (n + 1) * 128 * size + 4 * 128
    assert (whole <= MAX_SMEM) == fits
    mo = MacroOneShot(**args)
    assert mo.plan[0] == 128 and mo.plan[3] == (whole <= RESIDENT_SMEM) and mo.smem <= MAX_SMEM
    if mo.plan[3]:
        assert mo.smem == whole
    else:       # slices of at most about 17 KB, two to four of them
        assert mo.plan[1] * column_stride(CHUNK_ROWS) * size <= 17408 and mo.plan[2] >= 2
    assert mo.smem_one <= MAX_SMEM
    pts = _points(20, degree)
    P = torch.as_tensor(pts).to(dtype)
    want = mo(P)
    assert tuple(want.shape) == (40, 20) and mo.launches == 0
    if dtype == torch.float64:
        got = _replay_k3(mo, pts)
        assert np.abs(got - want.numpy()).max() <= RTOL_REPLAY * np.abs(want.numpy()).max()


def test_k3_tri_tables_past_shared_memory_run_plain_and_interpolate():
    """Lagrange 9 on Powell-Sabin-12 splits beside P1: K3's tables chunk
    (12 pieces of 55 x 34 values) and the 55-member Phi tile take 235,840
    bytes in f64, past 227 KB, so the plan streams the chunk through a ring
    of slices at 128 points, as it does one row a program.  The
    engines build; on the CPU the plain tables match fiat_tpu's CPU engine,
    the kernel's loop on the streamed slices matches the plain version, and
    the interpolation the port's own tables (the element is
    ill-conditioned: fiat_tpu's tables are 3.5e-6 and its interpolation
    8.1e-6 from host tabulation, the port's no further)."""
    pts = _points(200, 47)
    J, T = jcl.ufc_simplex(2), tcl.ufc_simplex(2)
    jzoo = [jfe.Lagrange(J, 1), jfe.Lagrange(J, 9, variant="powell-sabin(12)")]
    tzoo = [tfe.Lagrange(T, 1), tfe.Lagrange(T, 9, variant="powell-sabin(12)")]
    tab = device_tabulator(tzoo, order=0, device="cpu")
    mo = merged_macro(tab)
    assert mo.name == "K3" and (mo.rows, mo.K) == (514, 660)
    whole = 12 * 55 * column_stride(CHUNK_ROWS) * 8 + 55 * 128 * 8
    assert whole == 235_840 > MAX_SMEM >= mo.smem
    assert mo.plan[:1] + mo.plan[3:] == (128, False) and mo.smem_one <= MAX_SMEM
    jbt = JBatchedTabulator(jzoo, order=0)
    want = jbt.unpack(jbt(pts))
    got = tab.unpack(tab.block_tables(pts))
    diff = lambda ref, tabs: max(float(np.abs(np.asarray(r[a]) - np.asarray(g[a])).max())
                                 for r, g in zip(ref, tabs) for a in r)
    assert diff(want, got) <= ATOL_PS12_9
    host = [el.tabulate(0, pts) for el in jzoo]
    assert diff(host, got) <= diff(host, want) + ATOL_PS12_9
    # the kernel's loop on the streamed slices: the sums cancel (the change
    # of basis reaches 1e9), so they are held to the scale of |A| |B|
    P = torch.as_tensor(pts[:60])
    scale = _rounding_scale(mo, P).numpy()
    assert (np.abs(_replay_k3(mo, pts[:60]) - mo(P).numpy()) <= RTOL_REPLAY * scale).all()
    c = np.random.default_rng(29).random(max(hi for _, hi, _ in jbt.slices)) - 0.5
    u_want = np.asarray(jmo.interpolate_rows(jbt, jnp.asarray(pts), jnp.asarray(c)))
    tb = BatchedTabulator(tzoo, order=0, device="cpu")
    u = tmo.interpolate_rows(tb, pts, c).numpy()
    assert merged_macro(tb._moment_engine).smem_one <= MAX_SMEM
    # fiat_tpu's interpolation is itself 8.1e-6 from host here, the port's 2.1e-6
    u_host = c @ np.vstack([np.asarray(h[(0, 0)]) for h in host])
    assert np.abs(u - u_host).max() <= np.abs(u_want - u_host).max()
    assert np.abs(u - c @ np.vstack([g[(0, 0)].numpy() for g in got])).max() <= ATOL_PS12_9
    assert mo.launches == 0


def _rounding_scale(mo, P, A=None):
    """Per row r of K3's product, max over the points of |A_r| |B| (B its
    masked parent basis), as a column: the scale row r's sums round at."""
    B = mo.operand(P)[0]
    return ((mo.A if A is None else A).abs() @ B.abs()).amax(dim=1, keepdim=True)


def test_k3_tri_order3_matches_fiat_tpu_oneshot_interpreted_and_host():
    """The C1 zoo at order 3: K3's plain version against fiat_tpu's
    FusedMacroOneShot, built by hand from its macro programs as
    tests/test_device_ops.py:776-838 builds it, in interpret mode (its EFT
    pairs lose precision on XLA:CPU, so the bar is its own CPU bar), and the
    port's f64 engine against fiat_tpu's host tabulation."""
    pts = np.vstack([_points(200, 43), _special_points()])
    J = jcl.ufc_simplex(2)
    bt = JBatchedTabulator(_c1_zoo(jfe, J), order=3)
    rec_deg = max(p.degree for p in bt.macro_programs)
    t_es = bt.target_es
    A = np.zeros((sum(p.tall.shape[0] for p in bt.macro_programs),
                  sum(p.K for p in bt.macro_programs)))
    geom, pieces, r0, c0 = [], [], 0, 0
    for p in bt.macro_programs:
        ref = p.es.ref_el
        geom.append({"maps": [ref.barycentric_map(entity=(2, c), rescale=True) for c in p.cells],
                     "unique": False, "rows": (r0, r0 + p.tall.shape[0])})
        ratio = float(np.asarray(p.parent_es.get_scale(p.degree))
                      / np.asarray(t_es.get_scale(rec_deg)))
        A[r0:r0 + p.tall.shape[0], c0:c0 + p.K] = ratio * p.tall
        pieces += [(len(pieces) + i, p.nexp_parent) for i in range(len(p.cells))]
        r0, c0 = r0 + p.tall.shape[0], c0 + p.K
    parent_map = bt.macro_programs[0].es.ref_el.get_parent().barycentric_map(rescale=True)
    scale = float(np.asarray(t_es.get_scale(rec_deg, cell=0)))
    osk = FusedMacroOneShot(A, pieces, geom, parent_map, 2, rec_deg, scale, interpret=True,
                            wdtype="bf16", point_tile=256)
    hi, lo = jax.jit(lambda q: osk.apply_pair_points(q))(jnp.asarray(pts))
    want = np.asarray(hi, np.float64) + np.asarray(lo, np.float64)

    tzoo = _c1_zoo(tfe, tcl.ufc_simplex(2))
    tab = device_tabulator(tzoo, order=3, device="cpu")
    mo = merged_macro(tab)
    assert mo.name == "K3" and (mo.rows, mo.K) == A.shape == (330, 138)
    assert np.array_equal(mo.A.numpy(), A)
    got = mo(torch.as_tensor(pts)).numpy()
    assert np.abs(got - want).max() <= RTOL_INTERPRET * np.abs(want).max()
    tables = tab.unpack(tab.block_tables(pts))
    assert (tab.recurrence.launches, tab.matmul.launches, mo.launches) == (0, 0, 0)
    host = [el.tabulate(3, pts) for el in _c1_zoo(jfe, J)]
    assert max(float(np.abs(np.asarray(h[a]) - g[a].numpy()).max())
               for h, g in zip(host, tables) for a in h) <= ATOL_HOST
