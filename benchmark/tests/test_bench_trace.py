"""The reduction of a trace: busy time as the union of the device's
intervals, the idle gaps and what the host was doing in them, on made-up
intervals."""

from benchmark.trace import Trace, family


def made_up() -> Trace:
    device = [("flash_fwd_kernel", 10, 30), ("elementwise_kernel", 20, 40),
              ("nhwcToNchw", 60, 70)]
    host = [("cudaLaunchKernel", 0, 5), ("cudaLaunchKernel", 45, 50),
            ("cudaStreamSynchronize", 72, 100)]
    return Trace(device, host)


def test_busy_is_the_union_of_the_device_intervals():
    t = made_up()
    assert (t.start, t.end) == (0, 100)
    assert t.gaps() == [(0, 10), (40, 60), (70, 100)]
    assert abs(t.busy_s - 40e-9) < 1e-15 and abs(t.window_s - 100e-9) < 1e-15


def test_idle_goes_to_the_last_runtime_call():
    idle = made_up().idle_by_host()
    assert set(idle) == {"cudaLaunchKernel", "cudaStreamSynchronize"}
    assert abs(idle["cudaLaunchKernel"] - 30e-9) < 1e-15
    assert abs(idle["cudaStreamSynchronize"] - 30e-9) < 1e-15


def test_families():
    assert family("flash_fwd_kernel") == "flash_fwd (K1, K2)"
    assert family("nhwcToNchwKernel") == "layout nchw<->nhwc (cuDNN)"
    assert family("something_else") == "other"
