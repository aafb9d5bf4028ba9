"""Idle ms of the device per call of guidance.unet: each idle gap of the
traced window charged to the innermost program span open on the host at
its start (benchmark/program_spans.py)."""
from benchmark import program_spans


def read(run):
    return program_spans.idle_ms(run, "guidance.unet")
