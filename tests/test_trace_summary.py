"""utils.trace_summary: offline trace aggregation on a synthetic trace."""

import os

from jax.profiler import ProfileData

from mf_data_locality.utils import trace_summary

# one GPU plane with a per-kernel stream line and the per-HLO-op line, and a
# host plane whose events must not count
_XSPACE = """
planes {
  id: 1 name: "/device:GPU:0"
  lines { id: 1 name: "Stream #13(Compute)" timestamp_ns: 1000
    events { metadata_id: 1 offset_ps: 0 duration_ps: 7000000 }
    events { metadata_id: 2 offset_ps: 9000000 duration_ps: 40000000 }
  }
  lines { id: 2 name: "XLA Ops" timestamp_ns: 1000
    events { metadata_id: 1 offset_ps: 0 duration_ps: 10000000 }
    events { metadata_id: 1 offset_ps: 20000000 duration_ps: 5000000 }
    events { metadata_id: 2 offset_ps: 30000000 duration_ps: 40000000 }
  }
  event_metadata { key: 1 value { id: 1 name: "copy.1" } }
  event_metadata { key: 2 value { id: 2 name: "fusion.7" } }
}
planes {
  id: 2 name: "/host:CPU"
  lines { id: 1 name: "python"
    events { metadata_id: 1 offset_ps: 0 duration_ps: 99000000 }
  }
  event_metadata { key: 1 value { id: 1 name: "copy.9" } }
}
"""


def _write_trace(tmp_path, text=_XSPACE):
    d = os.path.join(tmp_path, "plugins", "profile", "run1")
    os.makedirs(d)
    with open(os.path.join(d, "host.xplane.pb"), "wb") as f:
        f.write(ProfileData.text_proto_to_serialized_xspace(text))
    return str(tmp_path)


def test_op_durations_and_matching(tmp_path):
    d = _write_trace(tmp_path)
    durs = trace_summary.op_durations(d)
    assert durs == {"copy.1": 15.0, "fusion.7": 40.0}
    assert trace_summary.total_matching(d, "copy.") == 15.0
    assert trace_summary.top_ops(d, 1) == [("fusion.7", 40.0)]
    # without an "XLA Ops" line the stream (kernel) lines are read
    no_ops = _XSPACE.replace('name: "XLA Ops"', 'name: "XLA Modules"')
    d2 = _write_trace(tmp_path / "b", no_ops)
    assert trace_summary.op_durations(d2) == {"copy.1": 7.0, "fusion.7": 40.0}


def test_empty_dir(tmp_path):
    assert trace_summary.op_durations(str(tmp_path)) == {}
    assert trace_summary.total_matching(str(tmp_path), "copy.") == 0.0
