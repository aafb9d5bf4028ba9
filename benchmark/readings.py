"""The readings that a cell's limits are set from: for each seed, the
numbers that decide `correct` (compare.py) of the program's first steps,
and with --control of the control's, the program with TF32 on in its
float32 matrix products and convolutions (the nearest precision below the
float32 with TF32 off that the configurations state). No window: set-up
runs one iteration of the epoch loop, through train_one_epoch, in which
the checked steps are.

    python3 benchmark/readings.py --workload <cell> --seeds 1 2 3 \
        [--control | --fault half_batch]

Prints one JSON line a seed; the benchmark's runs do not run this.
"""
import argparse
import contextlib
import json
import os
import sys
import time


@contextlib.contextmanager
def _state_unchanged():
    """Every optimizer update of the program leaves its state as it was."""
    import torch
    from morpheus_tpu_torch.train import optim
    update = optim._Optimizer.update

    def unchanged(self, grads, lr, frozen=(), ok=None):
        return torch.ones((), dtype=torch.bool, device=self.step.device)
    optim._Optimizer.update = unchanged
    try:
        yield
    finally:
        optim._Optimizer.update = update


@contextlib.contextmanager
def _half_batch():
    """The program's colour loss over half of the batch's rays, its mean
    taken over the rest."""
    from morpheus_tpu_torch.train import losses
    rgb = losses.rgb_loss

    def half(pred, gt, red):
        n = pred.shape[0] // 2
        return rgb(pred[:n], gt[:n], red)
    losses.rgb_loss = half
    try:
        yield
    finally:
        losses.rgb_loss = rgb


# the faults of the timed path that a one-card training cell can have
FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch}


def readings(cell: dict, seed: int, device="cuda", control: bool = False,
             cfg: dict | None = None, fault: str | None = None) -> dict:
    """The compared numbers of one seed: the program's, the control's with
    `control`, or with `fault` those of the program with that fault
    planted (FAULTS); and which of them the cell's limits pass."""
    from benchmark import compare, harness, inputs
    cfg = inputs.run_config(cell) if cfg is None else cfg
    harness.set_tf32(control)
    planted = FAULTS[fault]() if fault else contextlib.nullcontext()
    try:
        with planted:
            rec = harness.run_program(cell, cfg, seed, None, False, device,
                                      time.perf_counter(), setup_iters=1)
    finally:
        harness.set_tf32(False)
    kinds = rec["check"]["kinds"]
    ref = harness.run_reference(cell, cfg, seed, device, kinds)
    numbers = compare.numbers(rec["check"], ref, len(kinds))
    return {"seed": seed, "control": control, "fault": fault,
            "numbers": numbers,
            "within": {k: v <= cell["limits"][k]
                       for k, v in numbers.items()}}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control", action="store_true")
    p.add_argument("--fault", choices=sorted(FAULTS))
    args = p.parse_args(argv)
    sys.path[0] = os.path.dirname(os.path.dirname(os.path.abspath(
        __file__)))
    from benchmark import inputs
    cell = inputs.load_cell(args.workload)
    for seed in args.seeds:
        print(json.dumps(readings(cell, seed, "cuda", args.control,
                                  fault=args.fault)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
