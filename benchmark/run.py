"""The benchmark of morpheus_tpu_torch: one run of one cell on the card.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Prints, as the last line of standard output, one JSON object: correct,
attempted (optimizer steps in the window), failed, metrics (the cell's
end-to-end metrics, or with --trace 1 its per-layer ones), device and, with
--trace 1, breakdown; last in it, "compared": each number that decides
`correct` beside its limit, which standard error's last lines repeat. Exits
with another code than 0 and prints no result without a CUDA card, without
the port beside the benchmark, without the file of the configuration's SDS
prior (benchmark/guidance/<kind>.py), or when the process holds a module of
the JAX stack or of the JAX package after the window.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CACHE = os.path.join(ROOT, "_bench_cache")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    # every cache of the program at a fixed path inside the checkout
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = os.path.join(CACHE, sub)
    os.environ["USE_FLAX"] = "0"
    sys.path[0] = ROOT
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < 1:
        print("run.py: no CUDA card", file=sys.stderr)
        return 2
    try:
        import morpheus_tpu_torch  # noqa: F401
    except ImportError as e:
        print(f"run.py: the program is not here ({e})", file=sys.stderr)
        return 2
    from benchmark import harness, inputs
    cell = inputs.load_cell(args.workload)
    if int(cell["chips"]) != 1:
        print(f"run.py: {cell['name']} asks for {cell['chips']} cards; the "
              "harness runs one-card cells only", file=sys.stderr)
        return 2
    if torch.cuda.device_count() < int(cell["chips"]):
        print(f"run.py: {cell['chips']} cards asked for, "
              f"{torch.cuda.device_count()} here", file=sys.stderr)
        return 2
    try:
        harness.prior(inputs.run_config(cell))
    except (FileNotFoundError, ValueError) as e:
        print(f"run.py: {e}", file=sys.stderr)
        return 2
    harness.log("card:", harness.card_line("cuda"))
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), "cuda", t0=T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"run.py: the process holds {bad}", file=sys.stderr)
        return 3
    for k, v in result["compared"].items():
        harness.log(f"compared {k}: {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
