#!/usr/bin/env python3
"""Smoke run of fiat_tpu_torch on one CUDA card.

Drives the port's main paths once each at their real size, at 1e5 points
(bench.py's ``pts2``, seed 42), through the entry points a user calls:

  1. the nodal slice: Lagrange 1-10 + DiscontinuousLagrange 1-8,
     ``device_tabulator(..., order=1, device="cuda").block_tables`` (K1, K2);
  2. ``full_zoo`` (bench.py:840-862), the 42 triangle elements: the slice
     plus RT, Nedelec and BDM 1-6, CubicHermite, Morley, Argyris, Bell,
     and the macro elements HsiehCloughTocher 3 and QuadraticPowellSabin6,
     the same call in float64 (K1, K2, K3);
  3. ``moments_interp_full_zoo`` (bench.py:864-879): dual evaluation of
     ``full_zoo`` through ``ops.moments`` on a
     ``BatchedTabulator(full_zoo, order=0, device="cuda")``: ``moment_rows``
     (K45) and ``interpolate_rows`` (K1, K3), also timed at 1e7 points;
  4. ``full_zoo`` on the f32 engine,
     ``device_tabulator(..., order=1, f64=False, device="cuda").tables``
     (K6, K3 in float32), held against phase 2's float64 tables.

On the way it builds the CUDA kernels from ``fiat_tpu_torch/csrc``, holds
each kernel against its plain PyTorch version at the shapes each path
gives it, checks that each path launched every kernel of it (exactly once
from phase 2 on), checks the result against host tabulation, and times the
kernel path against the plain path with CUDA events.

Usage (from the repository root, on a machine with a CUDA card):

    python3 chip_smoke.py

Prints the card's name and power limit, one line per step, a JSON line
``{"kernels": [...]}`` (K1, K2 and K3 measured on ``full_zoo``, K45 on the
moments phase, K6 on the f32 phase), and as its last line
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``.
Exits non-zero, printing no result, if any phase fails or there is no
CUDA device.
"""

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

NPTS = 100_000
SEED = 42
HOST_CHECK_PTS = 2000
HOST_ATOL = 1e-10        # the BASELINE.json parity metric
KERNEL_RTOL = 1e-13      # kernel vs plain, relative to max |plain| (float64)
F32_KERNEL_RTOL = 1e-5   # float32 kernel vs plain: only the order of operations differs
F32_RTOL = 5e-6          # f32 plain rows vs float64, per alpha (tests/test_device_ops.py:143)
F32_MACRO_TOL = 5e-5     # f32 macro rows vs float64, / (max abs + 1) (:586-589)
BIG_NPTS = 10_000_000    # moments streamed from HBM: 240 MB of points and weights
REPS = 10
INNER = 10


def fail(msg):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def card_line():
    out = subprocess.run(["nvidia-smi", "-i", "0", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def median_ms(fn, torch, reps=REPS, inner=INNER, warmup=2):
    """Median over ``reps`` samples of the device time of one fn() call,
    each sample a run of ``inner`` calls between two CUDA events."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def rel_err(got, want):
    scale = want.abs().max().item()
    err = (got - want).abs().max().item()
    return err, err / scale if scale else err


def check_kernel(name, got, want, torch, rtol=KERNEL_RTOL):
    """Max abs and relative difference of a kernel from its plain version;
    fails past rtol."""
    torch.cuda.synchronize()
    err, rel = rel_err(got, want)
    print(f"{name} vs plain: max abs {err:.3e}, rel {rel:.3e}")
    if not rel <= rtol:
        fail(f"{name} disagrees with its plain version: rel {rel:.3e} > {rtol}")
    return err


def counted(engines, run, torch):
    """Run the main path once with every launch count set to 0 just before
    and read just after: (result, {kernel: launches})."""
    for eng in engines.values():
        eng.launches = 0
    out = run()
    torch.cuda.synchronize()
    return out, {k: eng.launches for k, eng in engines.items()}


def expect_launches(name, launches, want):
    print(f"{name} launches on the main path: {json.dumps(launches)}")
    if launches != want:
        fail(f"{name}: one pass must launch {want}, got {launches}")


def host_check(zoo, per, pts, npts, torch, np):
    """Max abs error of the per-element tables against host el.tabulate on
    the first HOST_CHECK_PTS points; fails on wrong alphas or shapes."""
    host_err = 0.0
    check = pts[:HOST_CHECK_PTS]
    for el, got in zip(zoo, per):
        want = el.tabulate(1, check)
        if set(want) != set(got):
            fail(f"{type(el).__name__}: alphas {sorted(got)} != {sorted(want)}")
        for a, w in want.items():
            g = got[a]
            if tuple(g.shape) != w.shape[:-1] + (npts,):
                fail(f"{type(el).__name__} {a}: shape {tuple(g.shape)}")
            host_err = max(host_err, float(np.abs(g[..., :HOST_CHECK_PTS].cpu().numpy() - w).max()))
    return host_err


def run_main_path(name, tab, zoo, pts2, torch, np):
    """One pass of ``block_tables`` with the launch counts set to 0 just
    before and read just after; checks finiteness and host parity."""
    engines = {"K1": tab.recurrence, "K2": tab.matmul}
    if tab.macro is not None:
        engines["K3"] = tab.macro
    blocks, launches = counted(engines, lambda: tab.block_tables(pts2), torch)
    finite = all(bool(torch.isfinite(b).all()) for bl in blocks.values() for b in bl)
    host_err = host_check(zoo, tab.unpack(blocks), pts2, NPTS, torch, np)
    print(f"{name} main path: device_tabulator(order=1).block_tables at {NPTS} points: "
          f"{len(zoo)} elements, finite {finite}, max abs err vs host el.tabulate on "
          f"{HOST_CHECK_PTS} points {host_err:.3e}")
    if not finite:
        fail(f"{name}: non-finite values in the tables")
    if not host_err <= HOST_ATOL:
        fail(f"{name}: main path disagrees with host tabulation: {host_err:.3e} > {HOST_ATOL}")
    print(f"{name} launches on the main path: {json.dumps(launches)}")
    if min(launches.values()) < 1:
        fail(f"{name}: a kernel of the main path was not launched: {launches}")
    return launches, host_err


def slice_phase(T, dev, pts2, P, card, torch, np):
    """Phase 1, kept from the first slice: Lagrange 1-10 + DG 1-8 on K1, K2."""
    from fiat_tpu_torch import DiscontinuousLagrange, Lagrange, device_tabulator

    t0 = time.perf_counter()
    zoo = ([Lagrange(T, p) for p in range(1, 11)]
           + [DiscontinuousLagrange(T, p) for p in range(1, 9)])
    tab = device_tabulator(zoo, order=1, device=dev)
    print(f"slice host construction: {len(zoo)} elements, {tab.rows} rows x {len(tab.alphas)} "
          f"alphas, widths {tab.widths}, {time.perf_counter() - t0:.2f} s")
    rec, mm = tab.recurrence, tab.matmul
    phi_p = rec.plain(P)
    check_kernel(f"slice K1 recurrence at {NPTS} points", rec(P), phi_p, torch)
    C_k, C_p = mm(phi_p), mm.plain(phi_p)
    check_kernel(f"slice K2 bucket matmul ({mm.total_rows} x {NPTS})", C_k, C_p, torch)
    worst = max(rel_err(a, b)[1] for a, b in zip(mm.views(C_k), mm.views(C_p)))
    if not worst <= KERNEL_RTOL:
        fail(f"slice K2 disagrees with its plain version on a group: rel {worst:.3e}")
    del phi_p, C_k, C_p
    run_main_path("slice", tab, zoo, pts2, torch, np)
    path_ms = median_ms(lambda: tab.block_tables(P), torch)
    plain_ms = median_ms(lambda: mm.plain(rec.plain(P)), torch)
    print(f"slice timing ({card}; median of {REPS} runs of {INNER}, CUDA events): "
          f"kernel path {path_ms:.4f} ms, plain path {plain_ms:.4f} ms")


def full_zoo(T):
    """The 42 elements of full_zoo, as bench.py:840-862 lists them."""
    import fiat_tpu_torch as ft
    return ([ft.Lagrange(T, p) for p in range(1, 11)]
            + [ft.DiscontinuousLagrange(T, p) for p in range(1, 9)]
            + [ft.RaviartThomas(T, k) for k in range(1, 7)]
            + [ft.Nedelec(T, k) for k in range(1, 7)]
            + [ft.BrezziDouglasMarini(T, k) for k in range(1, 7)]
            + [ft.CubicHermite(T), ft.Morley(T), ft.Argyris(T, 5), ft.Bell(T),
               ft.HsiehCloughTocher(T, 3), ft.QuadraticPowellSabin6(T)])


def full_zoo_phase(T, dev, pts2, P, card, torch, np):
    """Phase 2: the whole full_zoo on K1, K2 and K3, one launch each."""
    from fiat_tpu_torch import device_tabulator

    t0 = time.perf_counter()
    zoo = full_zoo(T)
    tab = device_tabulator(zoo, order=1, device=dev)
    rec, mm, mo = tab.recurrence, tab.matmul, tab.macro
    print(f"full_zoo host construction: {len(zoo)} elements, {tab.rows} rows x "
          f"{len(tab.alphas)} alphas, widths {tab.widths}, K3 {mo.rows} x {mo.K} over "
          f"{len(mo.nexp)} subcells (parent degree {mo.degree}), "
          f"{time.perf_counter() - t0:.2f} s")
    if len(zoo) != 42 or tab.macro is None:
        fail("full_zoo must hold 42 elements, the macro ones on K3")

    phi_p = rec.plain(P)
    k1_abs = check_kernel(f"full_zoo K1 recurrence at {NPTS} points", rec(P), phi_p, torch)
    k2_abs = check_kernel(f"full_zoo K2 bucket matmul ({mm.total_rows} x {NPTS})",
                          mm(phi_p), mm.plain(phi_p), torch)
    k3_abs = check_kernel(f"full_zoo K3 macro one-shot ({mo.rows} x {NPTS})",
                          mo(P), mo.plain(P), torch)
    del phi_p

    launches, host_err = run_main_path("full_zoo", tab, zoo, pts2, torch, np)
    if launches != {"K1": 1, "K2": 1, "K3": 1}:
        fail(f"full_zoo: one pass must launch K1, K2 and K3 once each: {launches}")

    phi = rec(P)
    k1_ms, k1_plain = median_ms(lambda: rec(P), torch), median_ms(lambda: rec.plain(P), torch)
    k2_ms, k2_plain = median_ms(lambda: mm(phi), torch), median_ms(lambda: mm.plain(phi), torch)
    k3_ms, k3_plain = median_ms(lambda: mo(P), torch), median_ms(lambda: mo.plain(P), torch)
    del phi
    path_ms = median_ms(lambda: tab.block_tables(P), torch)
    plain_ms = median_ms(lambda: (mm.plain(rec.plain(P)), mo.plain(P)), torch)
    gbytes = (mm.total_rows + mo.rows) * NPTS * 8 / 1e9
    print(f"full_zoo timing ({card}; median of {REPS} runs of {INNER}, CUDA events): "
          f"kernel path {path_ms:.4f} ms, plain path {plain_ms:.4f} ms; "
          f"K1 {k1_ms:.4f} ms (plain {k1_plain:.4f}), K2 {k2_ms:.4f} ms (plain {k2_plain:.4f}), "
          f"K3 {k3_ms:.4f} ms (plain {k3_plain:.4f}); a pass writes {gbytes:.3f} GB "
          f"= {gbytes / path_ms:.3f} TB/s; host error {host_err:.3e}")

    return tab, [
        entry("K1 dubiner2_values", "fiat_tpu_torch/csrc/recurrence.cu",
              "fiat_tpu/ops/pallas_recurrence.py:399", launches["K1"], k1_abs, k1_ms, k1_plain),
        entry("K2 bucket_matmul", "fiat_tpu_torch/csrc/bucket_matmul.cu",
              "fiat_tpu/ops/pallas_multiword.py:269", launches["K2"], k2_abs, k2_ms, k2_plain),
        entry("K3 macro_oneshot", "fiat_tpu_torch/csrc/macro_oneshot.cu",
              "fiat_tpu/ops/pallas_multiword.py:652", launches["K3"], k3_abs, k3_ms, k3_plain),
    ]


def entry(name, source, replaces, launches, err, ms, plain):
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": err, "ms": ms, "plain_ms": plain}


def make_points(n, seed, np):
    """bench.py's pts2: uniform in the UFC triangle's bounding square,
    pulled into the triangle."""
    rng = np.random.default_rng(seed)
    pts = rng.random((n, 2))
    return pts / (pts.sum(axis=1)[:, None] + 1e-9) * rng.random((n, 1))


def moments_phase(T, dev, pts2, P, card, torch, np):
    """Phase 3: moments_interp_full_zoo, moments on K45, interpolation on K1
    and K3, one launch each per pass."""
    from fiat_tpu_torch import device_tabulator
    from fiat_tpu_torch.ops import moments as mo
    from fiat_tpu_torch.ops.tabulate import BatchedTabulator

    t0 = time.perf_counter()
    zoo = full_zoo(T)
    bt = BatchedTabulator(zoo, order=0, device=dev)
    eng = mo.moment_engine(bt)
    pm, rec, m3 = eng.moments, eng.recurrence, eng.macro
    rows = eng.rows
    print(f"moments host construction: {len(zoo)} elements, {rows} rows, K45 {pm.rows} sums "
          f"(degree {pm.degree}: {pm.nplain} plain + {pm.rows - pm.nplain} masked over "
          f"{len(pm.piece_nexp)} subcells), {time.perf_counter() - t0:.2f} s")
    wf_h = np.random.default_rng(7).random(NPTS)      # bench.py:441
    wf = torch.as_tensor(wf_h, device=dev)
    c_h = np.random.default_rng(11).random(rows) - 0.5
    c = torch.as_tensor(c_h, device=dev)

    k45_abs = check_kernel(f"K45 pair moments ({pm.rows} sums over {NPTS} points)",
                           pm(P, wf), pm.plain(P, wf), torch)
    W = eng.program_columns * (c @ eng.matrix)[eng.nexp:]
    check_kernel(f"K3 one row per program ({W.shape[0]} x {W.shape[1]}, interpolation)",
                 m3(P, A=W), m3.plain(P, A=W), torch)

    engines = {"K45": pm, "K1": rec, "K3": m3}
    M, launches = counted(engines, lambda: mo.moment_rows(bt, P, wf), torch)
    expect_launches("moments", launches, {"K45": 1, "K1": 0, "K3": 0})
    moments_launches = launches["K45"]
    u, launches = counted(engines, lambda: mo.interpolate_rows(bt, P, c), torch)
    expect_launches("interpolation", launches, {"K45": 0, "K1": 1, "K3": 1})
    if tuple(M.shape) != (rows,) or tuple(u.shape) != (NPTS,):
        fail(f"moments {tuple(M.shape)} / interpolation {tuple(u.shape)}: wrong shapes")
    if not (bool(torch.isfinite(M).all()) and bool(torch.isfinite(u).all())):
        fail("non-finite moments or interpolated values")

    # against host tabulation in the bench's form (bench.py:476-486)
    sub, wsub = pts2[:HOST_CHECK_PTS], wf_h[:HOST_CHECK_PTS]
    per = mo.unpack_moments(bt, mo.moment_rows(bt, P[:HOST_CHECK_PTS], wf[:HOST_CHECK_PTS]))
    mom_err = interp_err = 0.0
    host_u = np.zeros(HOST_CHECK_PTS)
    for el, m, (lo, hi, _) in zip(zoo, per, bt.slices):
        tab = el.tabulate(0, sub)[(0, 0)]
        want = np.asarray(tab).reshape(tuple(m.shape) + (len(sub),)) @ wsub
        mom_err = max(mom_err, float(np.abs(want - m.cpu().numpy()).max()))
        host_u += c_h[lo:hi] @ np.asarray(tab).reshape(hi - lo, len(sub))
    interp_err = float(np.abs(u[:HOST_CHECK_PTS].cpu().numpy() - host_u).max())
    print(f"moments vs host el.tabulate(0) @ wf on {HOST_CHECK_PTS} points: max abs "
          f"{mom_err:.3e} (|M| <= {M.abs().max().item():.3e}); interpolation vs host "
          f"sum_i c_i phi_i: max abs {interp_err:.3e}")
    if not (mom_err <= HOST_ATOL and interp_err <= HOST_ATOL):
        fail(f"moments {mom_err:.3e} / interpolation {interp_err:.3e} > {HOST_ATOL}")

    def moments_plain(Q, w):
        return eng.matrix @ pm.plain(Q, w)

    def interp_plain(Q):
        folded = c @ eng.matrix
        return (folded[:eng.nexp] @ rec.plain(Q)
                + m3.plain(Q, A=eng.program_columns * folded[eng.nexp:]).sum(dim=0))

    k45_ms, k45_plain = median_ms(lambda: pm(P, wf), torch), median_ms(lambda: pm.plain(P, wf),
                                                                      torch)
    mom_ms = median_ms(lambda: mo.moment_rows(bt, P, wf), torch)
    mom_plain = median_ms(lambda: moments_plain(P, wf), torch)
    int_ms = median_ms(lambda: mo.interpolate_rows(bt, P, c), torch)
    int_plain = median_ms(lambda: interp_plain(P), torch)
    fz = device_tabulator(zoo, order=0, device=dev)
    via_ms = median_ms(lambda: [b @ wf for b in fz.block_tables(P)[(0, 0)]], torch)
    print(f"moments timing at {NPTS} points ({card}; median of {REPS} runs of {INNER}, CUDA "
          f"events): moment_rows {mom_ms:.4f} ms (plain {mom_plain:.4f}), K45 {k45_ms:.4f} ms "
          f"(plain {k45_plain:.4f}); interpolate_rows {int_ms:.4f} ms (plain {int_plain:.4f})")
    print(f"moments via tables at {NPTS} points ({card}): order-0 f64 engine (K1 + K2 + K3) "
          f"block_tables then each block @ wf: {via_ms:.4f} ms = {via_ms / mom_ms:.1f} x "
          f"moment_rows")
    del fz

    # 1e7 points: points and weights (240 MB) stream from HBM, past the L2
    big = torch.as_tensor(make_points(BIG_NPTS, SEED + 1, np), device=dev)
    wbig = torch.as_tensor(np.random.default_rng(8).random(BIG_NPTS), device=dev)
    check_kernel(f"K45 pair moments ({pm.rows} sums over {BIG_NPTS} points)",
                 pm(big, wbig), pm.plain(big, wbig), torch)
    big_ms = median_ms(lambda: mo.moment_rows(bt, big, wbig), torch)
    big_k45 = median_ms(lambda: pm(big, wbig), torch)
    big_plain = median_ms(lambda: moments_plain(big, wbig), torch, reps=3, inner=2)
    big_k45_plain = median_ms(lambda: pm.plain(big, wbig), torch, reps=3, inner=2)
    print(f"moments timing at {BIG_NPTS} points ({card}; CUDA events): moment_rows "
          f"{big_ms:.4f} ms (plain {big_plain:.4f}), K45 {big_k45:.4f} ms (plain "
          f"{big_k45_plain:.4f}); {24 * BIG_NPTS / 1e9 / big_k45:.3f} TB/s of points and "
          f"weights; plain peak memory {torch.cuda.max_memory_allocated() / 1e9:.1f} GB")
    del big, wbig
    torch.cuda.empty_cache()
    return [entry("K45 pair_moments", "fiat_tpu_torch/csrc/moments.cu",
                  "fiat_tpu/ops/pallas_recurrence.py:549, fiat_tpu/ops/pallas_recurrence.py:727", moments_launches,
                  k45_abs, k45_ms, k45_plain)]


def f32_phase(T, dev, P, ref64, card, torch):
    """Phase 4: full_zoo on the f32 engine, K6 and K3 in float32, one
    launch each; held against phase 2's float64 tables ``ref64``."""
    from fiat_tpu_torch import device_tabulator

    t0 = time.perf_counter()
    zoo = full_zoo(T)
    tab = device_tabulator(zoo, order=1, f64=False, device=dev)
    k6, m3 = tab.kernel, tab.macro
    print(f"f32 host construction: {len(zoo)} elements, {tab.rows} rows x {len(tab.alphas)} "
          f"alphas, K6 {k6.total_rows} rows in widths {k6.K}, K3 float32 {m3.rows} x {m3.K}, "
          f"{time.perf_counter() - t0:.2f} s")
    P32 = P.float()
    shape = (k6.total_rows, NPTS)
    k6_abs = check_kernel(f"K6 f32 zoo ({k6.total_rows} x {NPTS})",
                          k6(P32, tab.dst_plain, torch.empty(shape, device=dev)),
                          k6.plain(P32, tab.dst_plain, torch.empty(shape, device=dev)),
                          torch, F32_KERNEL_RTOL)
    m3_abs = check_kernel(f"K3 float32 macro one-shot ({m3.rows} x {NPTS})", m3(P32),
                          m3.plain(P32), torch, F32_KERNEL_RTOL)

    tables, launches = counted({"K6": k6, "K3 float32": m3}, lambda: tab.tables(P), torch)
    expect_launches("f32", launches, {"K6": 1, "K3 float32": 1})
    if not all(bool(torch.isfinite(t).all()) for t in tables.values()):
        fail("f32: non-finite values in the tables")

    # against the float64 kernel tables: plain rows per alpha relative to
    # their max abs, macro rows per element / (max abs + 1)
    pr = tab.plain_rows
    worst, zoo_err, zoo_max = 0.0, 0.0, 0.0
    for a in tab.alphas:
        d = (tables[a][:pr].double() - ref64[a][:pr]).abs()
        err, scale = d.max().item(), ref64[a][:pr].abs().max().item()
        row = int(d.max(dim=1).values.argmax().item())
        el = next(i for i, (lo, hi, _) in enumerate(tab.slices) if lo <= row < hi)
        print(f"f32 vs f64 plain rows {a}: max abs {err:.3e} / max {scale:.3e} = "
              f"{err / scale:.3e} (worst {type(zoo[el]).__name__} #{el})")
        worst = max(worst, err / scale)
        zoo_err, zoo_max = max(zoo_err, err), max(zoo_max, scale)
        if not err / scale <= F32_RTOL:
            fail(f"f32 plain rows {a}: {err / scale:.3e} > {F32_RTOL} at "
                 f"{type(zoo[el]).__name__} #{el}")
    macro_worst = 0.0
    for i in range(len(zoo)):
        lo, hi, _ = tab.slices[i]
        if lo < pr:
            continue
        for a in tab.alphas:
            ref = ref64[a][lo:hi]
            err = (tables[a][lo:hi].double() - ref).abs().max().item()
            rel = err / (ref.abs().max().item() + 1.0)
            macro_worst = max(macro_worst, rel)
            if not rel <= F32_MACRO_TOL:
                fail(f"f32 macro rows {type(zoo[i]).__name__} {a}: {rel:.3e} > {F32_MACRO_TOL}")
    print(f"f32 vs f64 on all {NPTS} points: zoo-wide plain rows {zoo_err / zoo_max:.3e} "
          f"(worst alpha {worst:.3e}, limit {F32_RTOL}); macro rows {macro_worst:.3e} "
          f"(limit {F32_MACRO_TOL})")
    del tables

    out = torch.empty(shape, device=dev)
    k6_ms = median_ms(lambda: k6(P32, tab.dst_plain, out), torch)
    k6_plain = median_ms(lambda: k6.plain(P32, tab.dst_plain, out), torch)
    m3_ms, m3_plain = median_ms(lambda: m3(P32), torch), median_ms(lambda: m3.plain(P32), torch)
    del out
    path_ms = median_ms(lambda: tab.tables(P), torch)
    full = torch.empty((len(tab.alphas) * tab.rows, NPTS), device=dev)
    plain_ms = median_ms(lambda: (k6.plain(P.float(), tab.dst_tables, full),
                                  full.index_copy_(0, tab.dst_macro, m3.plain(P.float()))), torch)
    del full
    gbytes = len(tab.alphas) * tab.rows * NPTS * 4 / 1e9
    print(f"f32 timing ({card}; median of {REPS} runs of {INNER}, CUDA events): tables "
          f"{path_ms:.4f} ms, plain path {plain_ms:.4f} ms; K6 {k6_ms:.4f} ms (plain "
          f"{k6_plain:.4f}), K3 float32 {m3_ms:.4f} ms (plain {m3_plain:.4f}); a pass writes "
          f"{gbytes:.3f} GB = {gbytes / path_ms:.3f} TB/s (K6 alone "
          f"{k6.total_rows * NPTS * 4 / 1e9 / k6_ms:.3f} TB/s)")
    return [entry("K6 zoo_f32", "fiat_tpu_torch/csrc/zoo_f32.cu",
                  "fiat_tpu/ops/pallas_tabulate.py:248", launches["K6"], k6_abs, k6_ms,
                  k6_plain)]


def main():
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device (torch.cuda.is_available() is false)")
    root = Path(__file__).resolve().parent
    if not (root / "fiat_tpu_torch" / "__init__.py").is_file():
        fail(f"the fiat_tpu_torch package is not beside {Path(__file__).name}")
    sys.path.insert(0, str(root))

    import numpy as np
    from fiat_tpu_torch import ufc_simplex
    from fiat_tpu_torch.ops.kernels import load_kernels

    dev = torch.device("cuda", 0)
    card = card_line()
    print(card)

    # -- build -------------------------------------------------------------
    t0 = time.perf_counter()
    lib = load_kernels()
    print(f"build: {lib.path.relative_to(root)} in {time.perf_counter() - t0:.1f} s")
    for line in lib.build_log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  ptxas: {line.strip()}")

    T = ufc_simplex(2)
    pts2 = make_points(NPTS, SEED, np)
    P = torch.as_tensor(pts2, device=dev)

    slice_phase(T, dev, pts2, P, card, torch, np)
    tab64, kernels = full_zoo_phase(T, dev, pts2, P, card, torch, np)
    ref64 = tab64(P)
    del tab64
    kernels += moments_phase(T, dev, pts2, P, card, torch, np)
    kernels += f32_phase(T, dev, P, ref64, card, torch)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
