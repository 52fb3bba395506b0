"""The flash forward kernels' (K1, K2) share of their roofline over the
profiled clip: the attention operations at their shapes
(`benchmark.flops.flash_attention_ops`, from the configuration) over the
dtype's peak, which bounds them (four products of every key and query
element against a few bytes of each), over the device time of the
operations named like the kernels. Nothing when no such operation ran."""

from benchmark.flops import flash_attention_ops
from benchmark.peaks import PEAK_FLOPS

PATTERN = r"flash_fwd"


def read(facts):
    trace = facts["trace"]
    if trace is None:
        return None
    seconds = trace.device_seconds(PATTERN)
    if seconds <= 0:
        return None
    cell = facts["cell"]
    cfg, traffic = cell.config, cell.traffic
    ops = flash_attention_ops(cfg, traffic["frames"], traffic["steps"])
    return 100.0 * ops / PEAK_FLOPS[cfg["dtype"]] / seconds
