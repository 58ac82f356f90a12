"""Kernel launches the host made in the traced wave (``cudaLaunchKernel``,
``cuLaunchKernel`` and their variants) per answer token the wave
completed, the tokens counted from the completions the harness
received."""


def read(rec):
    if rec.trace is None or rec.traced is None:
        return None
    tokens = sum(len(c.tokens) for c in rec.traced.completions.values())
    return rec.trace["launches"] / tokens if tokens else None
