"""The event filter of chip_smoke.py's trace(): every device time that
chip_smoke.py reports per grid is read from the device records it keeps.
Those are the records of the work that starts once the host range
"counted_runs" opens. A warm-up's or a primer's records come earlier and
are left out, and so is the range's own record on the device's timeline.
The profiler is not needed here: the events are stand-ins with the
fields the filter reads."""

from types import SimpleNamespace

import pytest

import chip_smoke

HOST, DEVICE = "cpu", "cuda"


def ev(name, device_type, start, end=None):
    return SimpleNamespace(name=name, device_type=device_type,
                           time_range=SimpleNamespace(
                               start=start,
                               end=start + 1 if end is None else end))


def test_counted_device_events_keeps_only_the_counted_runs():
    events = [
        ev("warm_up_kernel", DEVICE, 5),        # before the range: out
        ev("primer_zero_kernel", DEVICE, 20),   # the primer: out
        ev("cudaLaunchKernel", HOST, 25),       # a host record: out
        ev("counted_runs", HOST, 30, 200),      # the range on the host
        ev("counted_runs", DEVICE, 31, 190),    # its device record: out
        ev("chol_block_kernel", DEVICE, 30),    # at the range's start: in
        ev("below_tile_kernel", DEVICE, 40),
        ev("cudaLaunchKernel", HOST, 41),       # a host record: out
        ev("prod_tile_kernel", DEVICE, 60),
    ]
    kept = chip_smoke.counted_device_events(events, DEVICE)
    assert [e.name for e in kept] == ["chol_block_kernel",
                                      "below_tile_kernel",
                                      "prod_tile_kernel"]


def test_counted_device_events_starts_at_the_first_record_of_the_range():
    # the range's device record may start before its host record: the
    # earlier of the two opens the counted runs
    events = [ev("primer_zero_kernel", DEVICE, 10),
              ev("counted_runs", DEVICE, 28, 90),
              ev("counted_runs", HOST, 30, 100),
              ev("below_warp_kernel", DEVICE, 29)]
    kept = chip_smoke.counted_device_events(events, DEVICE)
    assert [e.name for e in kept] == ["below_warp_kernel"]


def test_counted_device_events_needs_the_range():
    with pytest.raises(ValueError):
        chip_smoke.counted_device_events(
            [ev("below_tile_kernel", DEVICE, 40)], DEVICE)
