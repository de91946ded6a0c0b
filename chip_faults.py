#!/usr/bin/env python3
"""Planted faults in the tensor-core routes, on one CUDA card:

    python3 chip_faults.py

For each fault, copies ``src/``, ``tests/`` and the two chip scripts into
``build/faults/<fault>/`` (listed in ``.gitignore``), plants the fault in
the copy's kernel source, and runs there, each in a subprocess:

  * ``chip_faults.py --read``: what the bf16 checks of ``chip_smoke.py``
    read on that tree, row by row (``row_rel``) — K4, K5 and K6 at their
    tensor-core walks' edges (``FLASH_TC_EDGES``, both layouts; the
    backward given the plain forward's lse and delta) and at the training
    path's shapes; K2 at its tile-edge rows (``EDGE_LENGTHS``, bf16 /
    int8 / fp8 pools, fitted and pool-wide tables, both rescales) and at
    phase 2's load, with the elementwise verdict;
  * the card tests, ``tests/test_torch_gpu.py``: the names that fail.

Then the same readings of this tree, the sound one.  The faults:

  * ``k4_diagonal``: each CTA of K4's walk drops its last key tile, the
    one the causal diagonal cuts;
  * ``k5_diagonal``: the same in K5's walk (dQ);
  * ``k6_head_loop``: K6's walk skips the last of the G query heads of
    its key head, so only the GQA / MQA cases can show it;
  * ``k2_tile_edge``: a K2 row whose limit (lengths[b] + c) ends a
    64-position tile loses that last position.

Exits non-zero if a fault's tree builds and runs yet every check passes
on it, or if the sound tree fails one.
"""
from __future__ import annotations

import os
import shutil
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = "src/repro_torch/kernels/csrc"
FAULTS = {
    "k4_diagonal": (
        "flash_attention_fwd_tc.cuh",
        "  const int n_tiles = k_hi > k_lo ? (k_hi - 1) / kKeys - t0 + 1 : 0;",
        "  const int n_tiles = max(1, (k_hi > k_lo ? (k_hi - 1) / kKeys - t0"
        " + 1 : 0) - (mk.causal ? 1 : 0));"),
    "k5_diagonal": (
        "flash_attention_bwd_tc.cuh",
        "  const int n_kt = k_hi > k_lo ? (k_hi - 1) / kKeys - t0 + 1 : 0;",
        "  const int n_kt = max(1, (k_hi > k_lo ? (k_hi - 1) / kKeys - t0 + 1"
        " : 0) - (mk.causal ? 1 : 0));"),
    "k6_head_loop": (
        "flash_attention_bwd_tc.cuh",
        "  const int n_total = a.G * nqt;",
        "  const int n_total = (a.G > 1 ? a.G - 1 : 1) * nqt;"),
    "k2_tile_edge": (
        "mla_prefill_paged.cu",
        "  const int n_pos = c < n_valid[b] ? min(lengths[b] + c + 1, nb * bs)"
        " : 0;",
        "  const int n_pos0 = c < n_valid[b] ? min(lengths[b] + c + 1, "
        "nb * bs) : 0;\n  const int n_pos = n_pos0 - (n_pos0 > 0 && "
        "n_pos0 % 64 == 0);"),
}


def read() -> int:
    """The readings of this tree's K4, K5, K6 and K2 checks; returns the
    number that exceed their bounds."""
    sys.path[:0] = [os.getcwd(), os.path.join(os.getcwd(), "src")]
    import torch

    import chip_smoke as cs
    from repro_torch.core import cache as cachelib
    from repro_torch.kernels import build, mla_prefill, ref
    from repro_torch.kernels import flash_attention as fa

    build.build_all()
    bad = 0

    def report(what, rel, bound, extra=""):
        nonlocal bad
        bad += not rel <= bound
        print(f"[read] {what}: largest per-row |kernel - plain| / |plain| "
              f"{rel:.3g} (bound {bound}){extra}", flush=True)

    tol = cs.FLASH_ROW_TOL["bfloat16"]
    names = {"flash_attention_fwd": "K4", "flash_attention_bwd_dq": "K5",
             "flash_attention_bwd_dkv": "K6"}
    worst, lse_worst, finite = {}, 0.0, True
    for i, case in enumerate(cs.FLASH_TC_EDGES):
        for blhd in (False, True):
            errs, lse_err, fin = cs.flash_tc_edge_errors(torch, fa, case,
                                                         50 + i, blhd)
            worst = {k_: max(worst.get(k_, 0.0), e) for k_, e in errs.items()}
            lse_worst, finite = max(lse_worst, lse_err), finite and fin
    for name, err in worst.items():
        report(f"{names[name]} at its walk's edges ({len(cs.FLASH_TC_EDGES)} "
               f"cases x 2 layouts)", err, tol,
               f", lse {lse_worst:.3g} (bound {cs.LSE_ATOL})"
               if name == "flash_attention_fwd" else
               f", gradients finite: {finite}")
    bad += not (lse_worst <= cs.LSE_ATOL and finite)
    path = (cs.TB, cs.TH, cs.TH, cs.TL, cs.TL, cs.TDQK, cs.TDV, None, 0)
    q, k, v, do = cs.flash_case_inputs(torch, path, torch.bfloat16, 99,
                                       blhd=True)
    kw = dict(causal=True, window=None, q_offset=0, scale=cs.TDQK ** -0.5)
    out, lse = fa.flash_fwd_kernel(q, k, v, **kw)
    out_p, lse_p = fa.flash_fwd_plain(q, k, v, **kw)
    report("K4 at the training path's shapes", cs.row_rel(torch, out, out_p),
           tol, f", lse {(lse - lse_p).abs().max().item():.3g}")
    delta = (do.float() * out_p.float()).sum(-1).contiguous()
    del out, lse, out_p
    got = fa.flash_bwd_dq_kernel(q, k, v, do, lse_p, delta, **kw)
    want = fa.flash_bwd_dq_plain(q, k, v, do, lse_p, delta, **kw)
    report("K5 at the training path's shapes", cs.row_rel(torch, got, want),
           tol)
    del got, want
    got = fa.flash_bwd_dkv_kernel(q, k, v, do, lse_p, delta, **kw)
    want = fa.flash_bwd_dkv_plain(q, k, v, do, lse_p, delta, **kw)
    report("K6 at the training path's shapes (dK, dV)",
           max(cs.row_rel(torch, a, b) for a, b in zip(got, want)), tol)
    del q, k, v, do, lse_p, delta, got, want
    torch.cuda.empty_cache()

    kern = mla_prefill.mla_prefill_paged_kernel
    tol = cs.TOL["bfloat16"]
    need = [a + b for a, b in zip(cs.EDGE_LENGTHS, cs.EDGE_NVALID)]
    ckv, krope, bt = cs.paged_inputs(torch, torch.float32, need, 7)
    wide = torch.zeros((cs.B, ckv.shape[0] - 1), dtype=torch.int32,
                       device="cuda")
    wide[:, :bt.shape[1]] = bt
    g = torch.Generator(device="cuda")
    g.manual_seed(8)
    q = torch.randn((cs.B, cs.C, cs.H, cs.DL + cs.DR), generator=g,
                    device="cuda").bfloat16()
    i32 = lambda a: torch.tensor(a, dtype=torch.int32, device="cuda")
    ln, nv = i32(cs.EDGE_LENGTHS), i32(cs.EDGE_NVALID)
    for pool in ("bf16", "int8", "fp8"):
        if pool == "bf16":
            c, r, qkw = ckv.bfloat16(), krope.bfloat16(), {}
        else:
            qdtype, qmax = cachelib.cache_dtype_info(pool)
            c, c_s = cachelib.quantize_latent(ckv, qmax, qdtype)
            r, r_s = cachelib.quantize_latent(krope, qmax, qdtype)
            qkw = dict(ckv_scales=c_s, krope_scales=r_s)
        for table, tname in ((bt, "fitted"), (wide, "pool-wide")):
            for rescale in ref.RESCALES:
                kw = dict(softmax_scale=cs.SCALE, rescale=rescale, **qkw)
                got = kern(q, c, r, table, ln, nv, **kw)
                want = ref.mla_prefill_paged_ref(q, c, r, table, ln, nv, **kw)
                diff = (got.float() - want.float()).abs().max().item()
                report(f"K2 tile-edge rows, {pool} pool, {tname} table, "
                       f"{rescale}", cs.row_rel(torch, got, want), tol,
                       f"; max |kernel - plain| {diff:.3g}")
    ckv, krope, bt = cs.paged_inputs(
        torch, torch.bfloat16,
        [max(a, b) for a, b in zip(cs.NEED_DEC, cs.NEED_PRE)], 1)
    kern, plain, args, kw = cs.paged_cases(
        torch, torch.bfloat16, ckv, krope, bt)["mla_prefill_paged"]
    for rescale in ref.RESCALES:
        got = kern(*args, rescale=rescale, **kw)
        want = plain(*args, rescale=rescale, **kw)
        ok = torch.allclose(got.float(), want.float(), atol=tol, rtol=tol)
        bad += not ok
        report(f"K2 at phase 2's load, {rescale}", cs.row_rel(torch, got,
                                                               want),
               tol, f"; elementwise (allclose {tol}) "
               f"{'passes' if ok else 'fails'}")
    return bad


def plant(name: str) -> str:
    """A copy of the tree under build/faults/<name> with the fault in."""
    src_file, old, new = FAULTS[name]
    root = os.path.join(HERE, "build", "faults", name)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    shutil.copytree(os.path.join(HERE, "src"), os.path.join(root, "src"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copytree(os.path.join(HERE, "tests"), os.path.join(root, "tests"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    for f in ("chip_smoke.py", "chip_faults.py"):
        shutil.copy(os.path.join(HERE, f), root)
    path = os.path.join(root, CSRC, src_file)
    with open(path) as fh:
        text = fh.read()
    if old not in text:
        raise AssertionError(f"{name}: the line to change is not in "
                             f"{src_file}")
    with open(path, "w") as fh:
        fh.write(text.replace(old, new))
    return root


def run_tree(root: str, label: str) -> tuple:
    """(check readings over their bounds, card tests failed) on a tree."""
    env = dict(os.environ, PYTHONPATH="src")
    rd = subprocess.run([sys.executable, "chip_faults.py", "--read"],
                        cwd=root, env=env, capture_output=True, text=True,
                        timeout=1200)
    for line in rd.stdout.splitlines():
        if line.startswith("[read]"):
            print(f"[{label}] {line[7:]}", flush=True)
    if rd.returncode < 0 or "Traceback" in rd.stderr:
        raise RuntimeError(f"{label}: the readings did not run\n"
                           f"{rd.stderr[-3000:]}")
    tests = subprocess.run([sys.executable, "-m", "pytest", "-q", "-m",
                            "gpu", "-p", "no:cacheprovider",
                            "tests/test_torch_gpu.py"],
                           cwd=root, env=env, capture_output=True, text=True,
                           timeout=1200)
    failed = [ln.split(" - ")[0][7:] for ln in tests.stdout.splitlines()
              if ln.startswith("FAILED ")]
    summary = tests.stdout.strip().splitlines()[-1] if tests.stdout else ""
    print(f"[{label}] card tests: {summary}", flush=True)
    for name in failed:
        print(f"[{label}]   failed {name}", flush=True)
    return rd.returncode, len(failed)


def main() -> int:
    if sys.argv[1:] == ["--read"]:
        return min(read(), 1)
    import torch

    if not torch.cuda.is_available():
        print("chip_faults: no CUDA device", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke

    print(f"[card] {chip_smoke.card_line()}", flush=True)
    ok = True
    for name in FAULTS:
        over, failed = run_tree(plant(name), name)
        ok &= over > 0 or failed > 0           # the fault must be caught
    over, failed = run_tree(HERE, "sound")
    ok &= over == 0 and failed == 0
    print(f"[faults] every planted fault caught and the sound tree clean: "
          f"{ok}", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
