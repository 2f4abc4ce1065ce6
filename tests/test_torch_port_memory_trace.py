"""scripts/memory_trace.py's replay of the allocator's trace, on a trace
made up here: the windows its markers open, each window's peak, the
blocks live at it (resident or made in the window) and their sites."""

from __future__ import annotations

import importlib.util
from pathlib import Path

ROOT = "/checkout"
_SPEC = importlib.util.spec_from_file_location(
    "memory_trace", Path(__file__).resolve().parents[1] / "scripts" / "memory_trace.py")
mt = importlib.util.module_from_spec(_SPEC)
_SPEC.loader.exec_module(mt)


def _frames(path, line, name="f"):
    return [{"filename": "/usr/lib/torch/nn/functional.py", "line": 1, "name": "conv"},
            {"filename": f"{ROOT}/{path}", "line": line, "name": name},
            {"filename": f"{ROOT}/chip_smoke.py", "line": 9, "name": "main"}]


def _alloc(addr, size, frames=()):
    return {"action": "alloc", "addr": addr, "size": size, "frames": list(frames)}


def _free(addr, size):
    return [{"action": "free_requested", "addr": addr, "size": size},
            {"action": "free_completed", "addr": addr, "size": size}]


def _trace():
    weights = _frames("monkeynet_tpu_torch/models/blocks.py", 70, "__init__")
    act = _frames("monkeynet_tpu_torch/models/blocks.py", 210, "forward")
    scratch = _frames("monkeynet_tpu_torch/ops/cuda/warp.py", 524, "warp_dsrc")
    base = {0x1000: (4096, weights)}
    events = [
        _alloc(0x9000, 999),  # before the first marker: not replayed
        _alloc(0x20000, mt.MARK + 512),  # window 0 opens
        *_free(0x20000, mt.MARK + 512),
        _alloc(0x2000, 1024, act),
        _alloc(0x3000, 2048, scratch),
        {"action": "free_requested", "addr": 0x2000, "size": 1024},
        _alloc(0x4000, 512, act),  # the peak: 4096 + 1024 + 2048 + 512
        {"action": "free_completed", "addr": 0x2000, "size": 1024},
        *_free(0x3000, 2048),
        _alloc(0x20000, mt.MARK),  # the path ends
        _alloc(0x5000, 10**6, act),  # between windows: counted, in no window
        *_free(0x5000, 10**6),
        _alloc(0x20000, mt.MARK + 1024),  # window 1 opens
        _alloc(0x3000, 2048, scratch),
        *_free(0x3000, 2048),
    ]
    return base, events


def test_replay_finds_each_windows_peak_and_the_blocks_live_at_it():
    base, events = _trace()
    (first0, peak0, live0, made0), (first1, peak1, live1, made1) = mt.replay(base, events)
    assert peak0 == 4096 + 1024 + 2048 + 512
    assert sorted(live0) == [0x1000, 0x2000, 0x3000, 0x4000]
    assert live0[0x1000][2] == -1 and all(live0[a][2] > first0 for a in (0x2000, 0x3000, 0x4000))
    assert sorted(size for size, _ in made0.values()) == [512, 1024, 2048]
    # window 1 starts from window 0's survivors (the base block and 0x4000)
    assert peak1 == 4096 + 512 + 2048
    assert sorted(live1) == [0x1000, 0x3000, 0x4000]
    assert [size for size, _ in made1.values()] == [2048]
    assert first1 > first0


def test_summarise_splits_resident_from_made_and_flags_the_wrappers_buffers():
    base, events = _trace()
    windows = mt.replay(base, events)
    s0 = mt.summarise(windows[0][0], windows[0][2], windows[0][3], ROOT)
    assert s0["resident_bytes"] == 4096 and s0["made_bytes"] == 1024 + 2048 + 512
    assert s0["sites"][0] == {"site": "monkeynet_tpu_torch/models/blocks.py:70 __init__",
                              "resident": True, "bytes": 4096, "blocks": 1}
    assert {"site": "monkeynet_tpu_torch/models/blocks.py:210 forward", "resident": False,
            "bytes": 1536, "blocks": 2} in s0["sites"]
    assert s0["wrapper_allocs"] == [{"site": "monkeynet_tpu_torch/ops/cuda/warp.py:524 warp_dsrc",
                                     "bytes": 2048, "count": 1, "live_at_peak": True}]
    s1 = mt.summarise(windows[1][0], windows[1][2], windows[1][3], ROOT)
    # 0x4000 was made in window 0: resident in window 1
    assert s1["resident_bytes"] == 4096 + 512 and s1["made_bytes"] == 2048


def test_sites_and_markers():
    assert mt.site_of(_frames("monkeynet_tpu_torch/tasks/train.py", 5, "step"), ROOT) == \
        "monkeynet_tpu_torch/tasks/train.py:5 step"
    assert mt.site_of([{"filename": "/usr/lib/torch/x.py", "line": 1, "name": "g"}], ROOT) == \
        "<torch>"
    assert mt.site_of([], ROOT) == "<none>"
    assert mt.marker(_alloc(0, mt.MARK)) == "end"
    assert mt.marker(_alloc(0, mt.MARK + 512 * 63)) == "open"
    assert mt.marker(_alloc(0, mt.MARK + mt.MARK_SPAN)) is None
    assert mt.marker({"action": "free_completed", "addr": 0, "size": mt.MARK + 512}) is None
    segments = [{"address": 0x100, "blocks": [
        {"size": 512, "state": "active_allocated", "frames": []},
        {"size": 1024, "state": "inactive"},
        {"size": 512, "state": "active_allocated", "frames": []}]}]
    assert sorted(mt.live_blocks(segments)) == [0x100, 0x100 + 512 + 1024]
