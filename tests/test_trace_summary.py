"""scripts/xprof_summary.py on small hand-made traces: which lanes are
device lanes, how self time treats nesting versus the slight overlaps of
consecutive GPU kernels, and how kernel names join the HLO's scopes."""

import gzip
import json
import os
import sys

import pytest

sys.path.insert(0, os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "scripts"))

import xprof_summary as xs  # noqa: E402


def _meta(pid, tid, pname, tname):
    return [
        {"ph": "M", "name": "process_name", "pid": pid,
         "args": {"name": pname}},
        {"ph": "M", "name": "thread_name", "pid": pid, "tid": tid,
         "args": {"name": tname}},
    ]


def _x(pid, tid, name, ts, dur):
    return {"ph": "X", "pid": pid, "tid": tid, "name": name, "ts": ts,
            "dur": dur}


@pytest.fixture
def gpu_trace(tmp_path):
    events = (
        _meta(1, 13, "/device:GPU:0", "Stream #13(Compute)")
        + _meta(701, 5, "/host:CPU", "python")
        + [
            _x(1, 13, "loop_fusion_1", 0.0, 10.0),
            # Starts 0.2 us before its predecessor ends: no nesting.
            _x(1, 13, "gemm_fusion_dot_2", 9.8, 20.0),
            _x(1, 13, "loop_fusion_1", 40.0, 10.0),
            _x(701, 5, "host_span", 0.0, 100.0),
        ])
    path = tmp_path / "run.trace.json.gz"
    with gzip.open(path, "wt") as f:
        json.dump({"traceEvents": events}, f)
    return path


def test_gpu_stream_lanes_are_device_lanes(gpu_trace):
    events = xs.load_events(str(gpu_trace))
    assert sorted(e["name"] for e in events) == [
        "gemm_fusion_dot_2", "loop_fusion_1", "loop_fusion_1"]


def test_self_time_ignores_overlap_but_subtracts_nested_children(gpu_trace):
    out = xs.self_times(xs.load_events(str(gpu_trace)))
    assert out == {"loop_fusion_1": 20.0, "gemm_fusion_dot_2": 20.0}

    nested = [_x(0, 0, "while", 0.0, 100.0), _x(0, 0, "body", 10.0, 30.0),
              _x(0, 0, "body", 50.0, 30.0)]
    assert xs.self_times(nested) == {"while": 40.0, "body": 60.0}


def test_hlo_scope_join_accepts_kernel_spelling(tmp_path):
    hlo = tmp_path / "hlo.txt"
    hlo.write_text(
        '  %loop_fusion.1 = f32[8]{0} fusion(%p), kind=kLoop, '
        'metadata={op_name="jit(f)/Update Iter/Learn/Optimize/'
        'jvp(AC Forward)/rnn.fwd_sequence/while/body/tanh"}\n'
        '  %copy.3 = f32[8]{0} copy(%p), metadata={op_name="jit(f)/x"}\n')
    scopes = xs.load_hlo_scopes(str(hlo))
    want = "Update Iter/Learn/Optimize/jvp(AC Forward)/rnn.fwd_sequence"
    assert scopes["loop_fusion.1"] == scopes["loop_fusion_1"] == want
    assert scopes["copy_3"] == "(no scope)"
    agg, counts = xs.scope_attribution(
        {"loop_fusion_1": 5.0, "nvjet_gemm": 2.0}, scopes)
    assert agg == {want: 5.0, "(unmapped)": 2.0}
