"""The port's GMH2 step-pipe codec (gubernator_tpu_torch/parallel/
multihost.py): the cases of tests/test_step_pipe_codec.py against it,
round-trip fidelity and hostile-frame rejection, plus the wire itself
against the JAX package's codec: the same messages encode to the same
bytes in both, and each decodes the other's frames. (The JAX module
imports jax only inside functions, so this loads no JAX runtime.)
"""

import socket
import struct
import threading

import numpy as np
import pytest

from gubernator_tpu_torch.parallel.multihost import (
    _MAGIC,
    _encode_msg,
    _recv_msg,
    _send_msg,
)


def _roundtrip(msg):
    a, b = socket.socketpair()
    try:
        t = threading.Thread(target=_send_msg, args=(a, msg))
        t.start()
        out = _recv_msg(b)
        t.join()
        return out
    finally:
        a.close()
        b.close()


def _recv_raw(raw: bytes):
    a, b = socket.socketpair()
    try:
        t = threading.Thread(target=a.sendall, args=(raw,))
        t.start()
        try:
            return _recv_msg(b)
        finally:
            t.join()
    finally:
        a.close()
        b.close()


def test_decide_message_roundtrips_bit_exact():
    n = 17
    msg = {
        "kind": "decide",
        "key_hash": np.arange(1, n + 1, dtype=np.uint64) << np.uint64(32),
        "hits": np.ones(n, np.int64),
        "limit": np.full(n, 10, np.int64),
        "duration": np.full(n, 1000, np.int64),
        "algo": np.zeros(n, np.int32),
        "gnp": np.zeros(n, bool),
        "now": 1_700_000_000_123,
    }
    out = _roundtrip(msg)
    assert set(out) == set(msg)
    assert out["kind"] == "decide" and out["now"] == msg["now"]
    for k in ("key_hash", "hits", "limit", "duration", "algo", "gnp"):
        assert out[k].dtype == msg[k].dtype
        np.testing.assert_array_equal(out[k], msg[k])


def test_hello_config_roundtrips_with_tuple_identity():
    # follower compares decoded config to its own with ==; tuples must
    # decode as tuples or every handshake would nack
    cfg = {
        "buckets": (64, 256, 1024, 4096),
        "sub_buckets": (64, 128),
        "store": (16, 4096),
        "n_shards": 8,
    }
    out = _roundtrip({"kind": "hello", "config": cfg})
    assert out["config"] == cfg
    assert isinstance(out["config"]["buckets"], tuple)


def test_none_and_error_string_fields():
    out = _roundtrip({"kind": "sync", "algo": None, "error": "boom ✓"})
    assert out["algo"] is None
    assert out["error"] == "boom ✓"


def test_pickle_frame_is_rejected_not_executed():
    import pickle

    payload = pickle.dumps({"kind": "ack"})
    raw = b"GMH1" + struct.pack("<Q", len(payload)) + payload
    with pytest.raises(ConnectionError):
        _recv_raw(raw)


def test_unknown_tag_rejected():
    body = bytes([250])
    raw = _MAGIC + struct.pack("<Q", len(body)) + body
    with pytest.raises(ConnectionError):
        _recv_raw(raw)


def test_unknown_dtype_rejected():
    # dict(1 entry) -> key "x" -> array tag with dtype code 9
    body = bytearray([5]) + struct.pack("<I", 1)
    body += struct.pack("<H", 1) + b"x"
    body += bytes([3, 9, 1]) + struct.pack("<I", 4)
    raw = _MAGIC + struct.pack("<Q", len(bytes(body))) + bytes(body)
    with pytest.raises(ConnectionError):
        _recv_raw(raw)


def test_truncated_array_rejected():
    msg = {"kind": "decide", "key_hash": np.arange(8, dtype=np.uint64)}
    raw = _encode_msg(msg)[:-3]
    # honest length header, short body: reader hits EOF
    a, b = socket.socketpair()
    try:
        a.sendall(raw)
        a.close()
        with pytest.raises(ConnectionError):
            _recv_msg(b)
    finally:
        b.close()


def test_length_lie_trailing_bytes_rejected():
    body = bytearray()
    from gubernator_tpu_torch.parallel.multihost import _encode_value

    _encode_value(body, {"kind": "ack"})
    body += b"XX"  # valid message followed by junk inside the frame
    raw = _MAGIC + struct.pack("<Q", len(bytes(body))) + bytes(body)
    with pytest.raises(ConnectionError):
        _recv_raw(raw)


def test_non_whitelisted_type_refuses_to_encode():
    with pytest.raises(ValueError):
        _encode_msg({"kind": "decide", "f": 1.5})
    with pytest.raises(ValueError):
        _encode_msg({"kind": "decide", "arr": np.zeros(4, np.float32)})


def test_invalid_utf8_rejected_as_connection_error():
    # hostile bytes in a string field must stay inside the codec's
    # declared error contract, not leak UnicodeDecodeError
    body = bytearray([5]) + struct.pack("<I", 1)
    body += struct.pack("<H", 1) + b"\xff"  # dict key is invalid utf-8
    body += bytes([0])  # value: None
    raw = _MAGIC + struct.pack("<Q", len(bytes(body))) + bytes(body)
    with pytest.raises(ConnectionError):
        _recv_raw(raw)
    # and in a string value
    body2 = bytearray([5]) + struct.pack("<I", 1)
    body2 += struct.pack("<H", 1) + b"k"
    body2 += bytes([2]) + struct.pack("<I", 2) + b"\xc3\x28"
    raw2 = _MAGIC + struct.pack("<Q", len(bytes(body2))) + bytes(body2)
    with pytest.raises(ConnectionError):
        _recv_raw(raw2)


def _messages():
    """A decide, a hello and a GHITS step as the leader sends them, and a
    nack as a follower does."""
    n = 9
    kh = (np.arange(1, n + 1, dtype=np.uint64) << np.uint64(40)) | np.uint64(0xFFFF_FFFF)
    kh[0] = np.uint64(2**64 - 1)  # the top bit set: travels as <u8, no sign
    return [
        {"kind": "decide", "key_hash": kh, "hits": np.arange(n, dtype=np.int64),
         "limit": np.full(n, 10, np.int64), "duration": np.full(n, 60_000, np.int64),
         "algo": (np.arange(n) % 4).astype(np.int32), "gnp": np.arange(n) % 3 == 0,
         "now": 1_700_000_000_123, "sk": 1},
        {"kind": "hello", "config": {"buckets": (16,), "sub_buckets": (16,),
                                     "store": (16, 256), "n_shards": 8,
                                     "sketch": (2, 1024, 8)}},
        {"kind": "ghits", "key_hash": kh, "hits": np.ones(n, np.int64),
         "limit": np.full(n, 7, np.int64), "duration": np.full(n, 1000, np.int64),
         "algo": None, "now": -5},
        {"kind": "nack", "error": "leader/follower config mismatch ✓"},
    ]


def _same_message(a: dict, b: dict) -> None:
    assert list(a) == list(b)
    for k in a:
        if isinstance(a[k], np.ndarray):
            assert a[k].dtype == b[k].dtype
            np.testing.assert_array_equal(a[k], b[k])
        else:
            assert a[k] == b[k] and type(a[k]) is type(b[k])


def test_both_packages_put_the_same_bytes_on_the_wire():
    """The port's _encode_msg and the JAX package's give identical frames
    for the same decide, hello, GHITS and nack messages, and each
    package's _recv_msg decodes the other's frames to the same message."""
    from gubernator_tpu.parallel import multihost as jmh
    from gubernator_tpu_torch.parallel import multihost as tmh

    for msg in _messages():
        wire = tmh._encode_msg(msg)
        assert wire == jmh._encode_msg(msg), msg["kind"]
        for enc, dec in ((tmh._encode_msg, jmh._recv_msg), (jmh._encode_msg, tmh._recv_msg)):
            _same_message(_recv_raw_with(dec, enc(msg)), msg)


def _recv_raw_with(recv, raw: bytes):
    a, b = socket.socketpair()
    try:
        t = threading.Thread(target=a.sendall, args=(raw,))
        t.start()
        try:
            return recv(b)
        finally:
            t.join()
    finally:
        a.close()
        b.close()
