"""The share of the profiled clip in which no operation ran on the device:
one less the union of the device operations' intervals over the traced
span."""


def read(facts):
    trace = facts["trace"]
    if trace is None:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
