"""Collector aggregation: loss accounting, stats.r summaries, log.sh
frame-success mining, JSONL round trip through tools/stats.py."""

import json
import subprocess
import sys

import numpy as np

from gr_dtl_jax.testbed import monitor
from gr_dtl_jax.testbed.collect import (Collector, frame_success,
                                        load_jsonl, summarize)
from gr_dtl_jax.testbed.proto import monitor_pb2


def _eq_blob(builder, snr, lost_rate=0.0, nmsgs=0):
    payload = monitor_pb2.MonitorEqMsg(
        constellation_key=2, fec_key=0, estimated_snr_tag_key=snr,
        noise_tag_key=0.01, lost_frames_rate=lost_rate)
    return builder.build(payload, nmsgs=nmsgs)


def test_collector_loss_and_summary():
    b = monitor.MonitorProto(monitor.EQ_MSG)
    col = Collector()
    snrs = [10.0, 12.0, 14.0, 16.0]
    blobs = [_eq_blob(b, s) for s in snrs]
    # drop the third message: sent_counter gap must be detected
    for i, blob in enumerate(blobs):
        if i != 2:
            col.feed(blob)
    assert col.n_received == 3
    assert col.lost() == 1
    s = col.summary()
    st = s["fields"]["estimated_snr_tag_key"]
    kept = [10.0, 12.0, 16.0]
    assert st["n"] == 3
    assert abs(st["mean"] - np.mean(kept)) < 1e-6
    assert abs(st["sd"] - np.std(kept, ddof=1)) < 1e-6
    assert st["median"] == 12.0
    assert st["min"] == 10.0 and st["max"] == 16.0


def test_frame_success_from_dec_counters():
    msgs = [
        {"proto_id": 0, "crc_ok_count": 5, "crc_fail_count": 0},
        {"proto_id": 0, "crc_ok_count": 9, "crc_fail_count": 1},
    ]
    assert frame_success(msgs) == 0.9


def test_frame_success_from_dict_stream():
    msgs = [{"crc_ok": True}] * 7 + [{"crc_ok": False}] * 3
    assert frame_success(msgs) == 0.7


def test_collector_ring_buffer_and_dicts():
    col = Collector(keep=4)
    for i in range(10):
        col.feed_dict({"snr": float(i), "crc_ok": i % 2 == 0})
    assert col.n_received == 10
    assert len(col.messages) == 4
    assert [m["snr"] for m in col.messages] == [6.0, 7.0, 8.0, 9.0]


def test_stats_cli_roundtrip(tmp_path):
    """JSONL capture -> tools/stats.py --json output."""
    b = monitor.MonitorProto(monitor.EQ_MSG)
    col = Collector()
    path = tmp_path / "telem.jsonl"
    with open(path, "w") as f:
        for snr in (8.0, 9.0, 10.0):
            msg = col.feed(_eq_blob(b, snr))
            json.dump(msg, f, default=str)
            f.write("\n")
    msgs = load_jsonl(str(path))
    assert len(msgs) == 3
    res = subprocess.run(
        [sys.executable, "tools/stats.py", str(path), "--json"],
        capture_output=True, text=True, check=True)
    out = json.loads(res.stdout)
    assert out["messages"] == 3
    assert abs(out["fields"]["estimated_snr_tag_key"]["mean"] - 9.0) < 1e-6


def test_collector_over_zmq():
    """Probe -> ZMQ PUB -> SUB -> Collector, end to end."""
    import zmq

    addr = "tcp://127.0.0.1:5599"
    probe = monitor.MonitorProbe(addr)
    ctx = zmq.Context.instance()
    sub = ctx.socket(zmq.SUB)
    sub.connect("tcp://127.0.0.1:5599")
    sub.setsockopt(zmq.SUBSCRIBE, b"")
    sub.setsockopt(zmq.RCVTIMEO, 2000)
    import time
    time.sleep(0.2)  # PUB/SUB join
    b = monitor.MonitorProto(monitor.EQ_MSG)
    for snr in (11.0, 13.0):
        probe.send(_eq_blob(b, snr))
    probe.send_dict({"crc_ok": True, "snr_db": 12.0})
    col = Collector()
    for _ in range(3):
        col.feed(sub.recv())
    sub.close(0)
    probe.close()
    assert col.n_received == 3 and col.lost() == 0
    s = col.summary()
    assert s["fields"]["estimated_snr_tag_key"]["n"] == 2
    assert s["frame_success_rate"] == 1.0
