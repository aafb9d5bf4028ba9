#!/usr/bin/env python
"""Microbenchmark of the row gather and the two accumulates over growing
hash tables (the port of scripts/bench_dense_scale.py): would a larger
model.grid_log2_hashmap_size (more dense levels, packable into wider rows)
pay on the card?

    python -m morpheus_tpu_torch.scripts.bench_dense_scale [--smoke]
        [--device cpu]

For each table of T rows of W float32 channels and S update sites (49,152,
the bench point's sites a step; --smoke: 4,096 sites, one 2^12 x 8 table):
  take           emb.index_select(0, idx)
  scatter-add    torch.zeros(T, W).index_add_(0, idx, ct): the library
                 accumulate (JAX's zeros.at[idx].add)
  sort+segsum    ops/segsum.segment_sum_unsorted: torch.sort, then
                 kernels/segment_sum_sorted.cu reading the payload through
                 the sort's order; the port's counterpart of
                 morpheus_tpu/ops/hashgrid._segsum_impl
ms by CUDA events (the host clock on the CPU), 20 calls after one. The two
accumulates must agree within 1e-5 of the largest sum, and on the card the
checked sort+segsum call must launch segment_sum_sorted, or the script
exits non-zero.
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from morpheus_tpu_torch import bench

TOL = 1e-5


def run(device, smoke: bool = False, reps: int = 20, log=bench.log) -> list:
    from morpheus_tpu_torch.__main__ import kernel_launches
    from morpheus_tpu_torch.ops import segsum
    S = 4096 if smoke else 49152
    tables = [1 << 12] if smoke else [1 << 15, 1 << 17, 1 << 19]
    widths = [8] if smoke else [2, 8, 16, 32]
    log(f"sites={S}  device={bench.card_line(device)}")
    rows = []
    for T in tables:
        for W in widths:
            g = torch.Generator().manual_seed(T * W)
            emb = torch.randn((T, W), generator=g).to(device)
            idx = torch.randint(0, T, (S,), generator=g).to(device)
            ct = torch.randn((S, W), generator=g).to(device)

            def scatter():
                return torch.zeros((T, W), device=device).index_add_(
                    0, idx, ct)

            def sseg():
                return segsum.segment_sum_unsorted(idx, ct, T)

            want = scatter()
            n0 = kernel_launches()["segment_sum_sorted"]
            err = float((sseg() - want).abs().max()) / float(
                want.abs().max())
            launches = kernel_launches()["segment_sum_sorted"] - n0
            tf = bench.time_ms(lambda: emb.index_select(0, idx), device, reps)
            tsc = bench.time_ms(scatter, device, reps)
            tss = bench.time_ms(sseg, device, reps)
            row = {"T": T, "W": W, "sites": S, "take_ms": tf,
                   "scatter_add_ms": tsc, "sort_segsum_ms": tss,
                   "max_rel_err": err, "launches": launches}
            rows.append(row)
            log(f"T=2^{T.bit_length() - 1:2d} W={W:2d}ch ({W * 4:3d}B/row): "
                f"take {tf:7.3f} ms ({S / tf * 1e-3:6.0f}M rows/s, "
                f"{S * W * 4 / tf / 1e6:6.1f} GB/s)  scatter-add {tsc:7.3f} "
                f"ms  sort+segsum {tss:7.3f} ms  max|err| {err:.1e}")
            log("dense_scale:", json.dumps(row))
    return rows


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--smoke", action="store_true")
    parser.add_argument("--device", default="cuda")
    args = parser.parse_args(argv)
    from morpheus_tpu_torch.utils import resolve_device
    device = resolve_device(args.device)
    rows = run(device, args.smoke)
    bad = [r for r in rows if not r["max_rel_err"] <= TOL
           or (device.type == "cuda" and r["launches"] < 1)]
    for r in bad:
        print(f"FAILED: T={r['T']} W={r['W']}: sort+segsum against "
              f"scatter-add {r['max_rel_err']:.3e} (limit {TOL}), "
              f"{r['launches']} segment_sum_sorted launches", flush=True)
    return 1 if bad else 0


if __name__ == "__main__":
    sys.exit(main())
