#!/usr/bin/env python3
"""Smoke run of fiat_tpu_torch on one CUDA card.

Drives the port's main path once at its real size: the Lagrange 1-10 +
DiscontinuousLagrange 1-8 triangle zoo, values plus first derivatives, in
float64, at 1e5 points, through ``device_tabulator(..., device="cuda")``
and ``block_tables``.  On the way it builds the CUDA kernels from
``fiat_tpu_torch/csrc``, holds each kernel against its plain PyTorch
version at the shapes the main path gives it, checks that the main path
launched every kernel, checks the result against host tabulation, and
times the kernel path against the plain path with CUDA events.

Usage (from the repository root, on a machine with a CUDA card):

    python3 chip_smoke.py

Prints the card's name and power limit, one line per phase, a JSON line
``{"kernels": [...]}``, and as its last line
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
    from fiat_tpu_torch import DiscontinuousLagrange, Lagrange, device_tabulator, ufc_simplex
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

    # -- host construction ---------------------------------------------------
    t0 = time.perf_counter()
    T = ufc_simplex(2)
    zoo = ([Lagrange(T, p) for p in range(1, 11)]
           + [DiscontinuousLagrange(T, p) for p in range(1, 9)])
    tab = device_tabulator(zoo, order=1, device=dev)
    rng = np.random.default_rng(SEED)
    pts2 = rng.random((NPTS, 2))
    pts2 = pts2 / (pts2.sum(axis=1)[:, None] + 1e-9) * rng.random((NPTS, 1))
    P = torch.as_tensor(pts2, device=dev)
    rows = tab.rows
    print(f"host construction: {len(zoo)} elements, {rows} rows x {len(tab.alphas)} alphas, "
          f"widths {tab.widths}, {time.perf_counter() - t0:.2f} s")

    # -- K1 vs plain ---------------------------------------------------------
    rec, mm = tab.recurrence, tab.matmul
    phi_k = rec(P)
    phi_p = rec.plain(P)
    torch.cuda.synchronize()
    k1_abs, k1_rel = rel_err(phi_k, phi_p)
    print(f"K1 recurrence vs plain at {NPTS} points: max abs {k1_abs:.3e}, rel {k1_rel:.3e}")
    if not k1_rel <= KERNEL_RTOL:
        fail(f"K1 disagrees with its plain version: rel {k1_rel:.3e} > {KERNEL_RTOL}")

    # -- K2 vs plain -----------------------------------------------------------
    C_k = mm(phi_p)
    C_p = mm.plain(phi_p)
    torch.cuda.synchronize()
    k2_abs, k2_rel = rel_err(C_k, C_p)
    worst = max(rel_err(a, b)[1] for a, b in zip(mm.views(C_k), mm.views(C_p)))
    print(f"K2 bucket matmul vs plain on {len(mm.K)} groups ({mm.total_rows} x {NPTS}): "
          f"max abs {k2_abs:.3e}, rel {k2_rel:.3e}, worst group rel {worst:.3e}")
    if not (k2_rel <= KERNEL_RTOL and worst <= KERNEL_RTOL):
        fail(f"K2 disagrees with its plain version: rel {k2_rel:.3e}, group {worst:.3e}")
    del phi_k, phi_p, C_k, C_p

    # -- the main path -----------------------------------------------------------
    rec.launches = mm.launches = 0
    blocks = tab.block_tables(pts2)
    torch.cuda.synchronize()
    launches = {"K1": rec.launches, "K2": mm.launches}
    per = tab.unpack(blocks)
    finite = all(bool(torch.isfinite(b).all()) for bl in blocks.values() for b in bl)
    host_err = 0.0
    check = pts2[:HOST_CHECK_PTS]
    for el, got in zip(zoo, per):
        want = el.tabulate(1, check)
        if set(want) != set(got):
            fail(f"{type(el).__name__}: alphas {sorted(got)} != {sorted(want)}")
        for a, w in want.items():
            g = got[a]
            if tuple(g.shape) != w.shape[:-1] + (NPTS,):
                fail(f"{type(el).__name__} {a}: shape {tuple(g.shape)}")
            host_err = max(host_err, float(np.abs(g[..., :HOST_CHECK_PTS].cpu().numpy() - w).max()))
    print(f"main path: device_tabulator(order=1).block_tables at {NPTS} points: "
          f"finite {finite}, max abs err vs host el.tabulate on {HOST_CHECK_PTS} points "
          f"{host_err:.3e}")
    if not finite:
        fail("non-finite values in the tables")
    if not host_err <= HOST_ATOL:
        fail(f"main path disagrees with host tabulation: {host_err:.3e} > {HOST_ATOL}")
    print(f"launches on the main path: {json.dumps(launches)}")
    if min(launches.values()) < 1:
        fail(f"a kernel of the main path was not launched: {launches}")
    del blocks, per

    # -- timing ------------------------------------------------------------------
    phi = rec(P)
    k1_ms = median_ms(lambda: rec(P), torch)
    k1_plain_ms = median_ms(lambda: rec.plain(P), torch)
    k2_ms = median_ms(lambda: mm(phi), torch)
    k2_plain_ms = median_ms(lambda: mm.plain(phi), torch)
    path_ms = median_ms(lambda: tab.block_tables(P), torch)
    plain_ms = median_ms(lambda: mm.plain(rec.plain(P)), torch)
    gbytes = mm.total_rows * NPTS * 8 / 1e9
    print(f"timing ({card}; median of {REPS} runs of {INNER}, CUDA events): kernel path {path_ms:.4f} ms, "
          f"plain path {plain_ms:.4f} ms; K1 {k1_ms:.4f} ms (plain {k1_plain_ms:.4f}), "
          f"K2 {k2_ms:.4f} ms (plain {k2_plain_ms:.4f}), K2 writes {gbytes:.3f} GB "
          f"= {gbytes / k2_ms:.3f} TB/s")

    kernels = [
        {"name": "K1 dubiner2_values", "route": "cuda",
         "source": "fiat_tpu_torch/csrc/recurrence.cu",
         "replaces": "fiat_tpu/ops/pallas_recurrence.py:399",
         "launches": launches["K1"], "max_abs_err": k1_abs,
         "ms": k1_ms, "plain_ms": k1_plain_ms},
        {"name": "K2 bucket_matmul", "route": "cuda",
         "source": "fiat_tpu_torch/csrc/bucket_matmul.cu",
         "replaces": "fiat_tpu/ops/pallas_multiword.py:269",
         "launches": launches["K2"], "max_abs_err": k2_abs,
         "ms": k2_ms, "plain_ms": k2_plain_ms},
    ]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
