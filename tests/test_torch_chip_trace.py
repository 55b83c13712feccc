"""The event filter of chip_smoke.py's trace(): every device time that
chip_smoke.py reports per grid is read from the device records it keeps.
Those are the records of the work that starts once the host range
"counted_runs" opens. A warm-up's or a primer's records come earlier and
are left out, and so is the range's own record on the device's timeline.
The stats phase reads the profile's timed runs off such a trace
(timed_windows) and names each factor grid's record category. The
profiler is not needed here: the events are stand-ins with the fields
the readers use."""

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


def test_timed_windows_reads_each_timed_run():
    # stats._Timer's runs: restore (a copy), sleep, the call's grids.
    # Its calibration sleeps and the untimed warm-up and replay runs
    # (no sleep before them) are left out
    spin = "void at::native::spin_kernel(long)"
    copy = "Memcpy DtoD (Device -> Device)"
    events = [ev(spin, DEVICE, 0, 5), ev(spin, DEVICE, 5, 9),
              ev(copy, DEVICE, 10), ev("chol_block_kernel<double>(", DEVICE,
                                       12),          # warm-up: out
              ev(copy, DEVICE, 14), ev(spin, DEVICE, 15, 20),
              ev("chol_block_kernel<double>(", DEVICE, 24, 30),
              ev("below_tile_kernel<double, 32>(", DEVICE, 31, 33),
              ev(copy, DEVICE, 34), ev(spin, DEVICE, 35, 40),
              ev("seg_short_kernel<long>(", DEVICE, 44, 45),
              ev(copy, DEVICE, 46),
              ev("chol_warp_kernel<double, 4>(", DEVICE, 47)]  # replay
    runs = chip_smoke.timed_windows(events)
    assert [(t, [chip_smoke._short(e.name) for e in w]) for t, w in runs] \
        == [(20, ["chol_block_kernel", "below_tile_kernel"]),
            (40, ["seg_short_kernel"])]


@pytest.mark.parametrize("name, category", [
    ("void chol_warp_kernel<double, 4>(double*, long)", "potrf"),
    ("void below_tile_kernel<double, 32>(double*)", "trsm"),
    ("void prod_entry_kernel<float>(float*)", "syge"),
    ("void wide_update_kernel<double>(double*)", "wide"),
    ("void seg_post_kernel<int>(int*)", "asmbl"),
    ("void dense_warp_kernel<double>(double*)", "dense_upd"),
    ("void at::native::spin_kernel(long)", None),
    ("Memcpy DtoD (Device -> Device)", None)])
def test_grid_category_names_each_factor_grid(name, category):
    assert chip_smoke.grid_category(name) == category


def test_record_category_puts_wide_buckets_apart():
    assert chip_smoke.record_category(("potrf", 1024, 1, 0, 1.0)) == "wide"
    assert chip_smoke.record_category(("trsm", 3072, 64, 0, 1.0)) == "wide"
    assert chip_smoke.record_category(("potrf", 512, 1, 0, 1.0)) == "potrf"
    assert chip_smoke.record_category(("syge", 1024, 64, 9, 1.0)) == "syge"
