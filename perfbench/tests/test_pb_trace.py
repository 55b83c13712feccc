"""The trace arithmetic on a made-up event list: device records given to
the span whose op launched them, busy time as a union, idle gaps named
by the host's span."""

from types import SimpleNamespace

import pytest

from perfbench import trace as tr

CPU, CUDA = "cpu", "cuda"


def ev(name, a, b, dev=CPU, id=0):
    return SimpleNamespace(
        name=name, device_type=dev, id=id,
        time_range=SimpleNamespace(start=a, end=b,
                                   elapsed_us=lambda a=a, b=b: b - a))


def events():
    # host: one step 0..100 us; in the factor (10..40) an op
    # (aten::copy_, id 7 like a runtime call of another id space) makes
    # a memcpy (runtime call 1) and a kernel k1 is launched (call 2); the
    # solve (40..60) launches k2 (call 3); the device runs them late (the
    # host runs ahead), and shows the spans' own annotation records,
    # which are left out
    return [
        ev("bench.steps", 0, 100), ev("bench.step", 0, 100),
        ev("bench.redamp", 0, 10), ev("bench.sync", 60, 100),
        ev("bench.factor", 10, 40), ev("aten::copy_", 12, 14, id=3),
        ev("cudaMemcpyAsync", 13, 14, id=1),
        ev("cudaLaunchKernel", 20, 21, id=2),
        ev("bench.solve", 40, 60), ev("cudaLaunchKernel", 45, 46, id=3),
        ev("Memcpy DtoD", 15, 20, CUDA, id=1),
        ev("k1", 20, 50, CUDA, id=2), ev("k2(double*)", 70, 80, CUDA, id=3),
        ev("cudaLaunchKernel", 30, 31, id=4), ev("k3", 40, 48, CUDA, id=4),
        ev("bench.factor", 15, 50, CUDA),
    ]


def test_read():
    t = tr.read(events(), CUDA, steps=1, port_kernels={"k1", "k2", "k3"})
    assert t.window_s == pytest.approx(100e-6)
    assert t.busy_s == pytest.approx(45e-6)
    assert t.idle_share == pytest.approx(0.55)
    # k3 runs beside k1 (another stream): the factor's union is 35 us
    assert t.device_s_by_span == pytest.approx({"factor": 35e-6,
                                                "solve": 10e-6})
    assert t.kernels_by_span == {"factor": 3, "solve": 1}
    # the memcpy is not one of the port's kernels
    assert t.port_by_span == {"factor": 2, "solve": 1}
    assert t.unattributed == 0
    assert t.device_s_by_name == pytest.approx(
        {"Memcpy DtoD": 5e-6, "k1": 30e-6, "k2": 10e-6, "k3": 8e-6})
    # gaps: 0..15 (host mid 7.5: redamp), 50..70 (mid 60: sync),
    # 80..100 (mid 90: sync)
    assert sorted(t.gaps) == sorted([("redamp", pytest.approx(15e-6)),
                                     ("sync", pytest.approx(20e-6)),
                                     ("sync", pytest.approx(20e-6))])
    b = t.breakdown(2)
    assert [k for k, _ in b["device_ops"]] == ["k1", "k2"]
    assert len(b["idle_gaps"]) == 2


def test_lost_kernel_record_shows():
    """A kernel record the profiler lost lowers the port's count even
    where another record of the span is not the port's."""
    ev_ = [e for e in events() if e.name != "k3"]
    t = tr.read(ev_, CUDA, steps=1, port_kernels={"k1", "k2", "k3"})
    assert t.port_by_span == {"factor": 1, "solve": 1}
    assert t.kernels_by_span == {"factor": 2, "solve": 1}


def test_union():
    assert tr.union([(0, 2), (1, 3), (5, 6)]) == 4
    assert tr.union([]) == 0
    assert tr.short_name("void ns::chol_block_kernel<double>(double*, "
                         "long)") == "chol_block_kernel"
