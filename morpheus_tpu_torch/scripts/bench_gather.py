#!/usr/bin/env python
"""Microbenchmark of the hash grid's gather / accumulate routes at the
bench point's stream (the port of scripts/bench_gather.py): a 16-level
grid of up to 2^15 rows with the fused sdf+color table (level_dim 4), 10
active levels x 8 corners x 40,960 points, level-major.

    python -m morpheus_tpu_torch.scripts.bench_gather [mode ...] [--device cpu]

Modes, each through ops/hashgrid.take_rows:
  rows              index_select under torch's autograd (backward
                    index_add_): the library route, as jnp.take in JAX
  hist_rows         kernels/row_gather.cu; backward
                    kernels/level_histogram.cu
  mxu_rows          kernels/level_gather.cu (3 bf16 planes, f32 to 1 ulp);
                    backward level_histogram
  mxu_rows_bf16     the same with a bf16 payload (one plane; the
                    histogram rounds the cotangent to bf16)
  sort_pallas_rows  row_gather; backward torch.sort, then
                    kernels/segment_sum_sorted.cu

For f(e) = take_rows(e, ...), the ms of (CUDA events; the host clock on
the CPU): the forward sum(f(e) * ct); the forward and backward (its
gradient g with respect to e); and the second order, the gradient of
sum(g * g) with respect to ct, which differentiates the accumulate again
(its backward is the route's gather) as the normals do. JAX's grad of
sum(g * g) with respect to e, which scripts/bench_gather.py times, is
identically zero for a linear f. Each mode's max|err| of the forward, the
gradient and the second order is against the same computation through a
plain index_select, relative to the largest reference value, and must be
within TOL (f32 payloads 1e-5; a bf16 payload 2^-7); on the card each
mode must launch the kernels of its route (ROUTE_KERNELS) and no other.
Any failure exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from morpheus_tpu_torch import bench

# mode -> (tpu.vjp_mode, gradient payload type)
MODES = {"rows": ("scatter", None),
         "hist_rows": ("hist_rows", None),
         "mxu_rows": ("mxu_rows", None),
         "mxu_rows_bf16": ("mxu_rows", torch.bfloat16),
         "sort_pallas_rows": ("sort_pallas_rows", None)}
ROUTE_KERNELS = {"rows": (),
                 "hist_rows": ("row_gather", "level_histogram"),
                 "mxu_rows": ("level_gather", "level_histogram"),
                 "mxu_rows_bf16": ("level_gather", "level_histogram"),
                 "sort_pallas_rows": ("row_gather", "segment_sum_sorted")}
# max|err| relative to the largest |reference| value, by payload type
TOL = {None: 1e-5, torch.bfloat16: 2.0 ** -7}


def make_stream(device, num_levels: int = 16, level_dim: int = 4,
                log2_hashmap_size: int = 15, active: int = 10,
                points: int = 40960, seed: int = 0) -> dict:
    """The table (T, level_dim) ~ 0.1 N(0, 1), the level-major local index
    stream (active, 8 * points) int32, each level's start row, and the
    cotangent (active * 8 * points, level_dim) ~ N(0, 1), from a CPU
    generator of `seed`."""
    from morpheus_tpu_torch.ops.hashgrid import HashGridSpec
    spec = HashGridSpec(input_dim=3, num_levels=num_levels,
                        level_dim=level_dim, base_resolution=16,
                        log2_hashmap_size=log2_hashmap_size,
                        desired_resolution=128)
    offs = spec.offsets
    g = torch.Generator().manual_seed(seed)
    emb = torch.randn((spec.table_size, level_dim), generator=g) * 0.1
    idx = torch.stack([torch.randint(0, offs[l + 1] - offs[l],
                                     (8 * points,), generator=g)
                       for l in range(active)]).to(torch.int32)
    ct = torch.randn((idx.numel(), level_dim), generator=g)
    return {"emb": emb.to(device), "idx": idx.to(device),
            "starts": list(offs[:active]), "ct": ct.to(device)}


def _funcs(take):
    """(forward, gradient, second order) of f = take (module doc)."""
    def fwd(e, ct):
        with torch.no_grad():
            return (take(e) * ct).sum()

    def grad(e, ct):
        e = e.detach().requires_grad_()
        return torch.autograd.grad((take(e) * ct).sum(), e)[0]

    def second(e, ct):
        e = e.detach().requires_grad_()
        ct = ct.detach().requires_grad_()
        (g,) = torch.autograd.grad((take(e) * ct).sum(), e,
                                   create_graph=True)
        return torch.autograd.grad((g * g).sum(), ct)[0]
    return fwd, grad, second


def run_mode(mode: str, stream: dict, reps: int = 20) -> dict:
    """One mode's times, errors against the plain index_select route, and
    the kernels it launched in its checked calls (module doc)."""
    from morpheus_tpu_torch.__main__ import kernel_launches
    from morpheus_tpu_torch.ops.hashgrid import take_rows
    vjp_mode, payload = MODES[mode]
    emb, idx, starts, ct = (stream[k] for k in ("emb", "idx", "starts",
                                                "ct"))
    dev = emb.device
    got = _funcs(lambda e: take_rows(e, idx, starts, vjp_mode, payload))
    ref = _funcs(lambda e: take_rows(e, idx, starts, "scatter"))
    n0 = kernel_launches()
    rows = (idx.long() + torch.as_tensor(starts, device=dev).reshape(-1, 1)
            ).reshape(-1)
    with torch.no_grad():
        pairs = [("fwd", take_rows(emb, idx, starts, vjp_mode, payload),
                  emb.index_select(0, rows))]
    pairs += [(name, f(emb, ct), r(emb, ct))
              for name, f, r in zip(("grad", "second"), got[1:], ref[1:])]
    errs = {name: float((a.float() - b).abs().max())
            / max(float(b.abs().max()), 1e-30) for name, a, b in pairs}
    bench.sync(dev)
    launches = {k: n - n0[k] for k, n in kernel_launches().items()}
    fwd, grad, second = got
    return {"mode": mode, "rows": int(idx.numel()),
            "fwd_ms": bench.time_ms(lambda: fwd(emb, ct), dev, reps),
            "fwd_bwd_ms": bench.time_ms(lambda: grad(emb, ct), dev, reps),
            "second_ms": bench.time_ms(lambda: second(emb, ct), dev,
                                       max(1, reps // 2)),
            "max_rel_err": errs, "tol": TOL[payload], "launches": launches}


def check(res: dict, on_card: bool) -> list:
    """The faults of one mode's result: an error over its tolerance, and on
    the card a kernel of its route that did not launch or another that
    did."""
    faults = [f"{res['mode']} {k} max|err| {v:.3e} > {res['tol']:.3e}"
              for k, v in res["max_rel_err"].items() if not v <= res["tol"]]
    if on_card:
        want = ROUTE_KERNELS[res["mode"]]
        faults += [f"{res['mode']}: {k} launched {n} times"
                   for k, n in res["launches"].items()
                   if (n == 0) == (k in want)]
    return faults


def main(argv=None, stream_kw=None, reps: int = 20, log=bench.log) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("modes", nargs="*", help=f"of {list(MODES)} "
                        "(default: all)")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    modes = args.modes or list(MODES)
    unknown = [m for m in modes if m not in MODES]
    if unknown:
        parser.error(f"unknown modes {unknown}; have {list(MODES)}")
    from morpheus_tpu_torch.utils import resolve_device
    device = resolve_device(args.device)
    if device.type == "cuda":
        from morpheus_tpu_torch import kernels
        kernels.build_all()
    stream = make_stream(device, **(stream_kw or {}))
    log(f"rows={stream['idx'].numel()} table={tuple(stream['emb'].shape)} "
        f"device={bench.card_line(device)}")
    faults = []
    for mode in modes:
        res = run_mode(mode, stream, reps)
        n = res["rows"]
        log(f"{mode:18s} fwd {res['fwd_ms']:7.3f} ms   fwd+bwd "
            f"{res['fwd_bwd_ms']:7.3f} ms   2nd {res['second_ms']:7.3f} ms"
            f"   max|err| {max(res['max_rel_err'].values()):.2e}  "
            f"({n / res['fwd_ms'] * 1e-3:.0f}M rows/s fwd)")
        log("bench_gather:", json.dumps(res))
        faults += check(res, device.type == "cuda")
    for f in faults:
        log("FAILED:", f)
    return 1 if faults else 0


if __name__ == "__main__":
    sys.exit(main())
