"""Seconds from the start of the process's harness code to the start of
the window: CUDA start-up, weights, kernel build or load, calibration and
the warm-up wave."""


def read(rec):
    return rec.setup_s
