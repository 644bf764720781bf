"""Busy and idle time, gap labels and roofline shares from a synthetic trace."""

import pytest

from kbench import trace

MS = 1_000_000


def _slice(launches=()):
    dev = [("void flash_fwd_kernel<128>(FlashParams)", 0, 2 * MS),
           ("void int4_gemm_kernel(Int4Params)", 1 * MS, 3 * MS),     # overlaps
           ("void int4_gemv_kernel(Int4Params)", 6 * MS, 7 * MS),
           ("Memset (Device)", 9 * MS, 10 * MS)]
    host = [("kbench.engine.advance", 0, 10 * MS),
            ("aten::item", 3 * MS + 100, 6 * MS - 100),
            ("cudaStreamSynchronize", 3 * MS + 200, 6 * MS - 200),
            ("aten::mm", 7 * MS + 10, 7 * MS + 20)]
    return trace.Slice(10e-3, dev, host, list(launches))


def test_busy_and_idle_share():
    sl = _slice()
    assert sl.busy_s == pytest.approx(5e-3)        # [0, 3) + [6, 7) + [9, 10) ms
    assert 100 * (1 - sl.busy_s / sl.window_s) == pytest.approx(50.0)
    assert trace.gaps(trace.busy_intervals([("a", 0, 2), ("b", 1, 3), ("c", 6, 7)]), 0, 10) \
        == [(3, 6), (7, 10)]


def test_gap_labels_name_what_the_host_did():
    labels = dict(_slice().idle_gaps)
    assert labels["engine.advance / cudaStreamSynchronize"] == pytest.approx(3e-3)
    assert labels["engine.advance / python"] == pytest.approx(2e-3)


def test_kernel_families_and_top_ops():
    sl = _slice()
    assert sl.kernel_count == {"flash": 1, "int4": 2}
    assert sl.device_s["int4"] == pytest.approx(3e-3)
    assert sl.device_ops[0][0].startswith("void flash_fwd_kernel") or \
        sl.device_ops[0][0].startswith("void int4_gemm")


def test_roofline_share_needs_matching_counts():
    flash = ("flash", 1, 32, 8, 1024, 1024, 128, True, None, 0, 1024)
    int4 = ("int4", 1024, 4096, 4096, 32, 2, 2)
    sl = _slice([flash, int4, int4])
    want = 100 * trace.launch_bound_s(flash) / 2e-3
    assert sl.roofline_pct("flash") == pytest.approx(want)
    assert 0 < sl.roofline_pct("int4") < 100
    assert _slice([flash, int4]).roofline_pct("int4") is None    # 1 launch, 2 kernels
    assert _slice([]).roofline_pct("flash") is None
