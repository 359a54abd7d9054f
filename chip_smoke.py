#!/usr/bin/env python3
"""Smoke run of fiat_tpu_torch on one CUDA card.

Drives the port's main paths once each at their real size, values plus
first derivatives, in float64, at 1e5 points, through
``device_tabulator(..., device="cuda")`` and ``block_tables``:

  1. the nodal slice: Lagrange 1-10 + DiscontinuousLagrange 1-8 (K1, K2);
  2. ``full_zoo`` (bench.py:840-862), the 42 triangle elements: the slice
     plus RT, Nedelec and BDM 1-6, CubicHermite, Morley, Argyris,
     Bell, and the macro elements HsiehCloughTocher 3 and
     QuadraticPowellSabin6 (K1, K2, K3).

On the way it builds the CUDA kernels from ``fiat_tpu_torch/csrc``, holds
each kernel against its plain PyTorch version at the shapes each path
gives it, checks that each path launched every kernel of it (exactly once
on ``full_zoo``), checks the result against host tabulation, and times the
kernel path against the plain path with CUDA events.

Usage (from the repository root, on a machine with a CUDA card):

    python3 chip_smoke.py

Prints the card's name and power limit, one line per step, a JSON line
``{"kernels": [...]}`` (K1, K2 and K3, measured on ``full_zoo``), and as
its last line
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
KERNEL_RTOL = 1e-13      # kernel vs plain, relative to max |plain|
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


def check_kernel(name, got, want, torch):
    """Max abs and relative difference of a kernel from its plain version;
    fails past KERNEL_RTOL."""
    torch.cuda.synchronize()
    err, rel = rel_err(got, want)
    print(f"{name} vs plain: max abs {err:.3e}, rel {rel:.3e}")
    if not rel <= KERNEL_RTOL:
        fail(f"{name} disagrees with its plain version: rel {rel:.3e} > {KERNEL_RTOL}")
    return err


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
    for eng in engines.values():
        eng.launches = 0
    blocks = tab.block_tables(pts2)
    torch.cuda.synchronize()
    launches = {k: eng.launches for k, eng in engines.items()}
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

    def entry(name, source, replaces, key, err, ms, plain):
        return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
                "launches": launches[key], "max_abs_err": err, "ms": ms, "plain_ms": plain}

    return [
        entry("K1 dubiner2_values", "fiat_tpu_torch/csrc/recurrence.cu",
              "fiat_tpu/ops/pallas_recurrence.py:399", "K1", k1_abs, k1_ms, k1_plain),
        entry("K2 bucket_matmul", "fiat_tpu_torch/csrc/bucket_matmul.cu",
              "fiat_tpu/ops/pallas_multiword.py:269", "K2", k2_abs, k2_ms, k2_plain),
        entry("K3 macro_oneshot", "fiat_tpu_torch/csrc/macro_oneshot.cu",
              "fiat_tpu/ops/pallas_multiword.py:652", "K3", k3_abs, k3_ms, k3_plain),
    ]


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
    rng = np.random.default_rng(SEED)
    pts2 = rng.random((NPTS, 2))
    pts2 = pts2 / (pts2.sum(axis=1)[:, None] + 1e-9) * rng.random((NPTS, 1))
    P = torch.as_tensor(pts2, device=dev)

    slice_phase(T, dev, pts2, P, card, torch, np)
    kernels = full_zoo_phase(T, dev, pts2, P, card, torch, np)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
