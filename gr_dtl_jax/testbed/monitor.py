"""Telemetry: protobuf envelope builders, ZMQ PUB probe, parser + registry.

Mirrors the reference testbed monitoring stack (SURVEY.md #30-33):

- :class:`MonitorProto` — envelope builder stamping ms timestamps,
  queue depth and a sent counter (ref ``monitor_proto.h:102-128``,
  ``monitor_probe_impl.cc:76-77``),
- :class:`MonitorProbe` — message sink publishing over a ZMQ PUB socket
  (ref ``monitor_probe_impl.cc:25-41``); two encodings, sniffable by
  the first byte like the reference's parser (``monitor_parser.cc:9-46``):
  * ``0x5c`` + serialized ``MonitorProtoMsg`` (proto payload in Any),
  * ``0x07`` pair-carrier: ``(sent_counter . (nmsgs . proto blob))`` —
    the reference's proto-blob-in-pmt-pair encoding
    (``monitor_probe_impl.cc:86-98``; 0x07 is pmt's serialized PAIR
    tag).  The counters ride the *carrier*, not the envelope, exactly
    as the reference's parser expects (``monitor_parser.cc:24-33``);
    byte-level layout of the carrier fields is this framework's (there
    is no pmt library here), but tag-sniffing and structure match,
  * ``0x7b`` (= '{') JSON dict for self-describing messages (stands in
    for the reference's serialized-pmt-dict encoding),
- :class:`MonitorParser` — collector-side decode back to dicts via a
  proto-id registry (ref ``monitor_registry.h:28-65``'s
  REGISTER_PARSERS).

The chain side stays pure: jitted chains return telemetry *arrays*
(RxOut fields); :func:`eq_messages` / :func:`dec_messages` convert a
batch of results into per-frame messages on the host, off the hot path.
"""

from __future__ import annotations

import json
import time
import typing as t

import numpy as np

from gr_dtl_jax.testbed.proto import monitor_pb2

__all__ = [
    "FEC_DEC_MSG", "EQ_MSG", "system_ts",
    "MonitorProto", "MonitorProbe", "MonitorParser",
    "register_parser", "eq_messages", "dec_messages",
]

# proto ids (ref lib/dtl/ofdm_adaptive_monitor.h:19-21)
FEC_DEC_MSG = 0
EQ_MSG = 1

PROTO_TAG = 0x5C  # ref monitor_probe_impl.cc:72
PAIR_TAG = 0x07  # pmt serialized-PAIR tag (ref probe's blob encoding)


def system_ts() -> int:
    """Milliseconds since epoch (ref monitor_msg.cc:18-22)."""
    return int(time.time() * 1000)


_PAYLOAD_TYPES: dict[int, t.Any] = {
    FEC_DEC_MSG: monitor_pb2.MonitorDecMsg,
    EQ_MSG: monitor_pb2.MonitorEqMsg,
}


def register_parser(proto_id: int, msg_class) -> None:
    """Register a payload type for a proto id (REGISTER_PARSERS analog)."""
    _PAYLOAD_TYPES[proto_id] = msg_class


class MonitorProto:
    """Envelope builder for one payload type."""

    def __init__(self, proto_id: int):
        self.proto_id = proto_id
        self.sent_counter = 0

    def build(self, payload_msg, nmsgs: int = 0) -> bytes:
        env = monitor_pb2.MonitorProtoMsg()
        env.time = system_ts()
        env.proto_id = self.proto_id
        env.nmsgs = nmsgs
        self.sent_counter += 1
        env.sent_counter = self.sent_counter
        env.payload.Pack(payload_msg)
        return bytes([PROTO_TAG]) + env.SerializeToString()

    def build_blob(self, payload_msg) -> bytes:
        """Bare serialized envelope, no tag byte — the 'blob' form a
        block hands to the probe for the pair-carrier encoding
        (ref monitor_probe_impl.cc:86: ``pmt::is_blob(msg)`` path;
        counters are stamped by the *probe* there, so nmsgs and
        sent_counter stay zero in this envelope)."""
        env = monitor_pb2.MonitorProtoMsg()
        env.time = system_ts()
        env.proto_id = self.proto_id
        env.payload.Pack(payload_msg)
        return env.SerializeToString()


class MonitorProbe:
    """ZMQ PUB telemetry publisher (ref monitor_probe_impl.cc).

    ``address=None`` runs in capture mode (messages buffered in
    ``.captured``) — the reference QA's fake ``test_sender``
    (qa_monitor_proto.cc:19-29) as a first-class mode.
    """

    def __init__(self, address: str | None = "tcp://*:5550", bind: bool = True):
        self.captured: list[bytes] = []
        self.sent_counter = 0  # carrier counter (ref message_sender's)
        self._sock = None
        if address is not None:
            import zmq

            self._ctx = zmq.Context.instance()
            self._sock = self._ctx.socket(zmq.PUB)
            (self._sock.bind if bind else self._sock.connect)(address)

    def send(self, blob: bytes) -> None:
        if self._sock is not None:
            self._sock.send(blob)
        else:
            self.captured.append(blob)

    def send_dict(self, d: dict) -> None:
        d = dict(d)
        d.setdefault("time", system_ts())
        self.send(json.dumps(d).encode())

    def send_blob(self, blob: bytes, nmsgs: int = 0) -> None:
        """Pair-carrier encoding: wrap a bare envelope blob
        (``MonitorProto.build_blob``) as
        ``(sent_counter . (nmsgs . blob))`` — the reference probe's
        third encoding (monitor_probe_impl.cc:86-98).  The probe stamps
        its own sent counter and the queue depth on the *carrier*."""
        import struct

        self.sent_counter += 1
        self.send(struct.pack(">BQQ", PAIR_TAG, self.sent_counter,
                              nmsgs) + blob)

    def close(self) -> None:
        if self._sock is not None:
            self._sock.close(0)
            self._sock = None


class MonitorParser:
    """Collector-side decode: sniff the tag byte, return a flat dict
    (ref monitor_parser.cc:9-92 reflection populate)."""

    @staticmethod
    def _env_to_dict(env) -> dict:
        out = {
            "time": env.time,
            "proto_id": env.proto_id,
            "nmsgs": env.nmsgs,
            "sent_counter": env.sent_counter,
        }
        cls = _PAYLOAD_TYPES.get(env.proto_id)
        if cls is not None:
            payload = cls()
            env.payload.Unpack(payload)
            for field in payload.DESCRIPTOR.fields:
                out[field.name] = getattr(payload, field.name)
        return out

    def parse(self, blob: bytes) -> dict:
        if not blob:
            return {}
        if blob[0] == PROTO_TAG:
            env = monitor_pb2.MonitorProtoMsg()
            env.ParseFromString(blob[1:])
            return self._env_to_dict(env)
        if blob[0] == PAIR_TAG:
            # pair carrier (sent_counter . (nmsgs . proto blob)): the
            # counters come from the CARRIER, as in the reference
            # parser (monitor_parser.cc:24-33 sets nmsgs from the pair)
            import struct

            _tag, counter, nmsgs = struct.unpack(">BQQ", blob[:17])
            env = monitor_pb2.MonitorProtoMsg()
            env.ParseFromString(blob[17:])
            out = self._env_to_dict(env)
            out["nmsgs"] = nmsgs
            out["sent_counter"] = counter
            return out
        return json.loads(blob.decode())


# ---------------------------------------------------------------------------
# chain-results -> messages (host side, off the jitted path)
# ---------------------------------------------------------------------------

def eq_messages(rx_out, lost_frames_rate: float = 0.0,
                fec_key: int = 0) -> list:
    """Per-frame MonitorEqMsg payloads from an RxOut batch
    (ref ofdm_adaptive_frame_equalizer_vcvc_impl.cc:210-216)."""

    cnst = np.asarray(rx_out.cnst_id)
    snr = np.asarray(rx_out.snr_db)
    noise = np.asarray(rx_out.noise_var)
    msgs = []
    for i in range(cnst.shape[0]):
        msgs.append(monitor_pb2.MonitorEqMsg(
            constellation_key=int(cnst[i]),
            fec_key=fec_key,
            estimated_snr_tag_key=float(snr[i]),
            noise_tag_key=float(noise[i]),
            lost_frames_rate=float(lost_frames_rate),
        ))
    return msgs


def dec_messages(rx_out, fec, crc_ok_count: int, crc_fail_count: int) -> list:
    """Per-frame MonitorDecMsg payloads from a FEC RxOut batch
    (ref ofdm_adaptive_fec_decoder_impl.cc:184-196)."""
    from gr_dtl_jax.ops import constellation as cn

    cnst = np.asarray(rx_out.cnst_id)
    iters = np.asarray(rx_out.avg_iters)
    plen = np.asarray(rx_out.payload_len)
    frame_no = np.asarray(rx_out.frame_no)
    msgs = []
    for i in range(cnst.shape[0]):
        bps = int(cn.BITS_PER_SYMBOL[cnst[i]])
        msgs.append(monitor_pb2.MonitorDecMsg(
            tb_no=int(frame_no[i]),
            tb_payload=int(plen[i]) * 8 + 32,
            tb_code_k=fec["k"],
            tb_code_n=fec["n"],
            tb_codewords=int(fec["ncws_tab"][bps]),
            frame_payload=int(fec["frame_bits_tab"][bps]),
            bps=bps,
            crc_ok_count=crc_ok_count,
            crc_fail_count=crc_fail_count,
            tber=0,
            avg_it=float(iters[i]),
        ))
    return msgs
