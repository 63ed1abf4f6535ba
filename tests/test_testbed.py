"""Telemetry build->probe->parse loop (mirrors qa_monitor_proto.cc:32-86
with a capture-mode probe as the fake sender) and frame-store/BER tools."""

import os
import subprocess
import sys

import numpy as np

from gr_dtl_jax.testbed import monitor
from gr_dtl_jax.testbed.frame_store import FrameStore, read_frames
from gr_dtl_jax.testbed.proto import monitor_pb2


def test_proto_roundtrip_capture():
    probe = monitor.MonitorProbe(address=None)  # capture mode
    builder = monitor.MonitorProto(monitor.EQ_MSG)
    payload = monitor_pb2.MonitorEqMsg(
        constellation_key=3, fec_key=1,
        estimated_snr_tag_key=17.25, noise_tag_key=0.01,
        lost_frames_rate=0.125,
    )
    probe.send(builder.build(payload, nmsgs=2))
    probe.send(builder.build(payload))
    parser = monitor.MonitorParser()
    out = parser.parse(probe.captured[0])
    assert out["proto_id"] == monitor.EQ_MSG
    assert out["constellation_key"] == 3
    assert abs(out["estimated_snr_tag_key"] - 17.25) < 1e-9
    assert out["nmsgs"] == 2 and out["sent_counter"] == 1
    assert parser.parse(probe.captured[1])["sent_counter"] == 2


def test_pair_carrier_roundtrip():
    """Third encoding (proto blob in a pair carrier,
    ref monitor_probe_impl.cc:86-98): the probe stamps sent_counter +
    nmsgs on the CARRIER; the parser must take them from there, not
    from the (zeroed) envelope — monitor_parser.cc:24-33 semantics."""
    probe = monitor.MonitorProbe(address=None)
    builder = monitor.MonitorProto(monitor.EQ_MSG)
    payload = monitor_pb2.MonitorEqMsg(
        constellation_key=4, fec_key=0,
        estimated_snr_tag_key=21.5, noise_tag_key=0.02,
        lost_frames_rate=0.0,
    )
    probe.send_blob(builder.build_blob(payload), nmsgs=5)
    probe.send_blob(builder.build_blob(payload))
    parser = monitor.MonitorParser()
    assert probe.captured[0][0] == monitor.PAIR_TAG
    out = parser.parse(probe.captured[0])
    assert out["proto_id"] == monitor.EQ_MSG
    assert out["constellation_key"] == 4
    assert abs(out["estimated_snr_tag_key"] - 21.5) < 1e-6
    # carrier counters win (the envelope's are zero in blob form)
    assert out["nmsgs"] == 5 and out["sent_counter"] == 1
    assert parser.parse(probe.captured[1])["sent_counter"] == 2


def test_all_three_encodings_sniffable_in_one_stream():
    """A collector must dispatch all three encodings off one socket by
    the first byte, like the reference parser."""
    probe = monitor.MonitorProbe(address=None)
    builder = monitor.MonitorProto(monitor.EQ_MSG)
    payload = monitor_pb2.MonitorEqMsg(constellation_key=2,
                                       estimated_snr_tag_key=9.0)
    probe.send(builder.build(payload))
    probe.send_blob(builder.build_blob(payload), nmsgs=1)
    probe.send_dict({"frames_ok": 7})
    parser = monitor.MonitorParser()
    outs = [parser.parse(b) for b in probe.captured]
    assert outs[0]["constellation_key"] == 2
    assert outs[1]["constellation_key"] == 2 and outs[1]["nmsgs"] == 1
    assert outs[2]["frames_ok"] == 7


def test_json_dict_roundtrip():
    probe = monitor.MonitorProbe(address=None)
    probe.send_dict({"frame_no": 12, "crc": "ok"})
    out = monitor.MonitorParser().parse(probe.captured[0])
    assert out["frame_no"] == 12 and out["crc"] == "ok"
    assert "time" in out


def test_zmq_pub_sub_loop():
    import zmq

    ctx = zmq.Context.instance()
    sub = ctx.socket(zmq.SUB)
    port = sub.bind_to_random_port("tcp://127.0.0.1")
    sub.setsockopt(zmq.SUBSCRIBE, b"")
    probe = monitor.MonitorProbe(f"tcp://127.0.0.1:{port}", bind=False)
    builder = monitor.MonitorProto(monitor.FEC_DEC_MSG)
    # PUB/SUB slow-joiner: retry-send until the subscriber sees a message
    blob = None
    for _ in range(100):
        probe.send(builder.build(monitor_pb2.MonitorDecMsg(tb_no=7, avg_it=2.5)))
        if sub.poll(100):
            blob = sub.recv()
            break
    assert blob is not None, "ZMQ PUB/SUB never connected"
    out = monitor.MonitorParser().parse(blob)
    assert out["tb_no"] == 7 and abs(out["avg_it"] - 2.5) < 1e-9
    probe.close()
    sub.close(0)


def test_frame_store_wrap_and_ber(tmp_path):
    tx_path = str(tmp_path / "tx.dat")
    rx_path = str(tmp_path / "rx.dat")
    rng = np.random.RandomState(0)
    frames = {n: rng.randint(0, 256, 20).astype(np.uint8).tobytes()
              for n in range(4090, 4096)} | {
              n: rng.randint(0, 256, 20).astype(np.uint8).tobytes()
              for n in range(0, 6)}
    with FrameStore(tx_path) as ts:
        for n in list(range(4090, 4096)) + list(range(0, 6)):
            ts.store(frames[n], n)
    # RX misses one frame, corrupts one byte of another
    with FrameStore(rx_path) as rs:
        for n in list(range(4090, 4096)) + list(range(0, 6)):
            if n == 4093:
                continue
            data = bytearray(frames[n])
            if n == 2:
                data[0] ^= 0xFF
            rs.store(bytes(data), n)

    recs = list(read_frames(tx_path))
    assert len(recs) == 12
    # wrap: long numbers strictly increasing across the 4095->0 boundary
    nos = [n for n, _ in recs]
    assert nos == sorted(nos) and nos[-1] == 4096 + 5

    sys.path.insert(0, "/root/repo/tools")
    import ber

    res = ber.score(tx_path, rx_path)
    assert res["frames_sent"] == 12
    assert res["frames_missed"] == 1
    assert res["crc_fail"] == 1
    assert res["ber_detected"] == 8 / (11 * 20 * 8)
    assert res["fer"] == 2 / 12


def test_eq_dec_messages_from_rxout():
    class FakeRx:
        cnst_id = np.array([2, 4])
        snr_db = np.array([15.0, 25.0])
        noise_var = np.array([0.01, 0.001])
        avg_iters = np.array([1.5, 0.0])
        payload_len = np.array([10, 53])
        frame_no = np.array([1, 2])

    msgs = monitor.eq_messages(FakeRx())
    assert msgs[0].constellation_key == 2
    assert abs(msgs[1].estimated_snr_tag_key - 25.0) < 1e-9

    from gr_dtl_jax.utils import alist as alist_mod, config as cfgmod
    from gr_dtl_jax.models import fec_chain
    cfg = cfgmod.make_tx_config(None, frame_length=10, fec=True)
    H = alist_mod.load_alist(os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "examples", "n_0100_k_0027.alist"))
    fec = fec_chain.build_fec(cfg, H)
    dmsgs = monitor.dec_messages(FakeRx(), fec, crc_ok_count=5, crc_fail_count=1)
    assert dmsgs[0].tb_code_n == 100 and dmsgs[0].tb_code_k == 27
    assert dmsgs[0].bps == 2 and dmsgs[1].bps == 4
