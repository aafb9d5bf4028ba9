"""Idle ms of the device per call of sds.grads, each idle gap charged to
the innermost program span open at its start (benchmark/program_spans.py)."""
from benchmark import program_spans


def read(run):
    return program_spans.idle_ms(run, "sds.grads")
