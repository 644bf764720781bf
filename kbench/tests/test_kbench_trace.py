"""Busy and idle time, gap labels and roofline shares from a synthetic trace;
a kernel family added as a file, its launches recorded by wrapping every
binding of its entry function."""

import sys
import types

import pytest

from kbench import lookup, trace

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


FAMILY = '''"""toy: a stand-in kernel family (a test of the lookup by file)."""

KERNELS = ("toy_kernel",)
ENTRY = "kbench_toyprog.kern:launch"


def record(args, kwargs):
    return (args[0],)


def bound_s(rec):
    return rec[0] * 1e-3
'''
KERN = '''
def launch(n, nested=False):
    launch.calls += 1
    if nested:
        launch(n)          # through the module's own name
    return n


launch.calls = 0
'''


@pytest.fixture
def toyprog(monkeypatch):
    """A stand-in program: the entry's module, and two modules that bind it,
    one under another name."""
    mods = {n: types.ModuleType(n) for n in
            ("kbench_toyprog", "kbench_toyprog.kern", "kbench_toyprog.a", "kbench_toyprog.b")}
    exec(KERN, mods["kbench_toyprog.kern"].__dict__)
    entry = mods["kbench_toyprog.kern"].launch
    mods["kbench_toyprog.a"].launch = entry
    mods["kbench_toyprog.b"].go = entry
    for n, m in mods.items():
        monkeypatch.setitem(sys.modules, n, m)
    return mods, entry


def test_a_kernel_family_is_a_file(tmp_path, toyprog):
    mods, entry = toyprog
    (tmp_path / "roofline" / "kernels").mkdir(parents=True)
    (tmp_path / "roofline" / "kernels" / "toy.py").write_text(FAMILY)
    tr = trace.Tracer(True, 0.0, 60.0, kroot=tmp_path)
    tr.install()
    bindings = [(mods["kbench_toyprog.kern"], "launch"), (mods["kbench_toyprog.a"], "launch"),
                (mods["kbench_toyprog.b"], "go")]
    assert all(getattr(m, n) is not entry for m, n in bindings)
    mods["kbench_toyprog.a"].launch(3)        # before the slice: not recorded
    tr.poll(0.0)
    mods["kbench_toyprog.a"].launch(5)
    mods["kbench_toyprog.b"].go(7, nested=True)
    mods["kbench_toyprog.kern"].launch(11)
    tr.close()
    assert tr.launches == [("toy", 5), ("toy", 7), ("toy", 11)]   # the nested call once
    assert entry.calls == 5                   # the program's own counter saw every call
    assert all(getattr(m, n) is entry for m, n in bindings)
    fams = {"toy": lookup.kernel_families(tmp_path)["toy"]}
    dev = [("toy_kernel<1>", 0, 10 * MS), ("toy_kernel<2>", 10 * MS, 20 * MS),
           ("toy_kernel<1>", 20 * MS, 46 * MS)]
    sl = trace.Slice(0.05, dev, [], tr.launches, fams)
    assert sl.kernel_count == {"toy": 3}
    assert sl.roofline_pct("toy") == pytest.approx(100 * (5 + 7 + 11) * 1e-3 / 46e-3)
    assert trace.Slice(0.05, dev[:2], [], tr.launches, fams).roofline_pct("toy") is None


def test_families_that_share_kernel_names_are_refused(tmp_path):
    d = tmp_path / "roofline" / "kernels"
    d.mkdir(parents=True)
    (d / "toy.py").write_text(FAMILY)
    (d / "toy2.py").write_text(FAMILY.replace('("toy_kernel",)', '("toy_kernel<2>",)'))
    with pytest.raises(ValueError, match="share kernel names"):
        lookup.kernel_families(tmp_path)
