"""Idle ms of the device per call of sds.update (train/trainer.py
virtual_step: the division, the non-finite check, the freeze update or the
carry), each idle gap charged to the innermost program span open at its
start (benchmark/program_spans.py)."""
from benchmark import program_spans


def read(run):
    return program_spans.idle_ms(run, "sds.update")
