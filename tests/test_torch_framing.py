"""The port's binary fleet framing (server/framing.py) against the
reference's: every verb's frame byte for byte from the same objects built
from a seed (protobuf and JSON pod codecs both), every decode round-trips
to the same content in both packages, and corrupt, truncated, oversized
and garbage input fails the same typed way in both. Exact everywhere."""

from __future__ import annotations

import random
import struct

import pytest

import kubernetes_tpu.api.serde as jserde
import kubernetes_tpu.models.hollow as jh
import kubernetes_tpu.server.framing as jf
import kubernetes_tpu_torch.api.serde as tserde
import kubernetes_tpu_torch.models.hollow as th
import kubernetes_tpu_torch.server.framing as tf

REF = (jf, jh, jserde)
PORT = (tf, th, tserde)


def _world(mods):
    """Pods and nodes of one package from fixed seeds: mixed-affinity
    pods carry labels, selectors and (anti-)affinity terms."""
    _f, h, _s = mods
    nodes = h.hollow_nodes(6, seed=3)
    for i, n in enumerate(nodes):
        n.labels["zone"] = f"z{i % 2}"
    pods = h.mixed_affinity_pods(8, seed=5) + h.gang_pods(6, seed=7)
    return {"nodes": nodes, "pods": pods, "serde": mods[2]}


def _pods(w, blob):
    return [w["serde"].encode_pod(p) for p in blob]


def _nodes(w, blob):
    return [w["serde"].encode_node(n) for n in blob]


AGG = {"cell": "c0", "gen": 3, "cpu_alloc_m": 64000, "pending": 2,
       "domains": ["z0", "z1"], "ready": True}

# name -> (encode(f, w) -> bytes, decode(f, w, payload) -> plain content)
CASES = {
    "filter": (
        lambda f, w: f.encode_filter_request(w["pods"][0], top_k=32,
                                             deadline_ms=10_000),
        lambda f, w, b: (lambda o: (w["serde"].encode_pod(o[0]), o[1], o[2]))(
            f.decode_filter_request(b))),
    "bind_with_spec": (
        lambda f, w: f.encode_bind_request(
            "p1", "bench", "u-1", "node-3", snapshot_gen=42,
            idem_key="bench/p1:3", deadline_ms=5000, pod=w["pods"][1]),
        lambda f, w, b: (lambda o: o[:7] + (w["serde"].encode_pod(o[7]),))(
            f.decode_bind_request(b))),
    "bind_ids_only": (
        lambda f, w: f.encode_bind_request("p1", "bench", "u-1", "node-3"),
        lambda f, w, b: f.decode_bind_request(b)),
    "sync_nodes": (
        lambda f, w: f.encode_sync_request(w["nodes"], "nodes"),
        lambda f, w, b: _nodes(w, f.decode_items_blob(b, "nodes"))),
    "sync_pods": (
        lambda f, w: f.encode_sync_request(w["pods"], "pods"),
        lambda f, w, b: _pods(w, f.decode_items_blob(b, "pods"))),
    "verdict": (
        lambda f, w: f.encode_verdict(9, False, 3, ["a", "b", "c"], ["d"],
                                      [("a", 100), ("b", -5)]),
        lambda f, w, b: f.decode_verdict(b)),
    "verdict_compact": (
        lambda f, w: f.encode_verdict(None, True, 5000, None, [], []),
        lambda f, w, b: f.decode_verdict(b)),
    **{f"bind_result_{k}": (
        (lambda k: lambda f, w: f.encode_bind_result(k, 17, "CONFLICT: x"))(k),
        lambda f, w, b: f.decode_bind_result(b)) for k in jf.BIND_KINDS},
    "overloaded": (lambda f, w: f.encode_overloaded(33),
                   lambda f, w, b: f.decode_overloaded(b)),
    "error": (lambda f, w: f.encode_error("boom é"),
              lambda f, w, b: f.decode_error(b)),
    "synced": (lambda f, w: f.encode_synced(7),
               lambda f, w, b: f.decode_synced(b)),
    "metrics_text": (lambda f, w: f.encode_metrics_text("a 1\nb 2\n"),
                     lambda f, w, b: f.decode_metrics_text(b)),
    "stats_request": (lambda f, w: f.encode_stats_request(64),
                      lambda f, w, b: f.decode_stats_request(b)),
    "stats_result": (
        lambda f, w: f.encode_stats_result({"vars": {"counter.x": 3},
                                            "trace": [{"k": "a"}]}),
        lambda f, w, b: f.decode_stats_result(b)),
    "relist_result": (
        lambda f, w: f.encode_relist_result(w["nodes"], w["pods"][:4]),
        lambda f, w, b: (lambda o: (_nodes(w, o[0]), _pods(w, o[1])))(
            f.decode_relist_result(b))),
    **{f"cell_agg_request_{int(d)}{int(e)}": (
        (lambda d, e: lambda f, w: f.encode_cell_agg_request(d, e))(d, e),
        lambda f, w, b: f.decode_cell_agg_request(b))
       for d in (False, True) for e in (False, True)},
    "cell_agg_result": (
        lambda f, w: f.encode_cell_agg_result(AGG, w["pods"][2:5]),
        lambda f, w, b: (lambda o: (o[0], _pods(w, o[1])))(
            f.decode_cell_agg_result(b))),
    "cell_agg_result_empty": (
        lambda f, w: f.encode_cell_agg_result(AGG, []),
        lambda f, w, b: f.decode_cell_agg_result(b)),
    "admit_request": (
        lambda f, w: f.encode_admit_request("fed0:c1:7", w["pods"]),
        lambda f, w, b: (lambda o: (o[0], _pods(w, o[1])))(
            f.decode_admit_request(b))),
    "admit_result": (lambda f, w: f.encode_admit_result(12, 3),
                     lambda f, w, b: f.decode_admit_result(b)),
    "trace_wrap": (
        lambda f, w: f.wrap_trace(f.encode_filter_request(w["pods"][3], 4),
                                  "trace-77"),
        lambda f, w, b: (lambda o: (o[0], len(o[1])))(
            f.unwrap_trace(b, f.FLAG_TRACE))),
}


@pytest.fixture(params=["proto", "json"])
def codec(request, monkeypatch):
    if request.param == "json":
        for f in (jf, tf):
            monkeypatch.setattr(f, "_proto_available", lambda: False)
    return request.param


@pytest.mark.parametrize("case", sorted(CASES))
def test_frames_byte_equal_and_round_trip(case, codec):
    enc, dec = CASES[case]
    wr, wp = _world(REF), _world(PORT)
    ref_payload, port_payload = enc(jf, wr), enc(tf, wp)
    assert port_payload == ref_payload
    verb = tf.ADMIT
    assert (tf.encode_frame(verb, 77, port_payload, flags=tf.FLAG_COMPACT)
            == jf.encode_frame(verb, 77, ref_payload, flags=jf.FLAG_COMPACT))
    (v, fl, rid, body), = tf.FrameDecoder().feed(
        tf.encode_frame(verb, 77, port_payload, flags=tf.FLAG_COMPACT))
    assert (v, fl, rid, body) == (verb, tf.FLAG_COMPACT, 77, port_payload)
    # the port decodes its own bytes to what the reference decodes from
    # the reference's
    assert dec(tf, wp, port_payload) == dec(jf, wr, ref_payload)


def test_pod_and_items_blobs_decode_across_packages(codec):
    """A blob the reference wrote decodes in the port to the same pods,
    and the other way round."""
    wr, wp = _world(REF), _world(PORT)
    rb = jf.encode_items_blob(wr["pods"], "pods")
    pb = tf.encode_items_blob(wp["pods"], "pods")
    assert _pods(wp, tf.decode_items_blob(rb, "pods")) \
        == _pods(wr, jf.decode_items_blob(pb, "pods")) \
        == _pods(wr, wr["pods"])
    for p, q in zip(wp["pods"], wr["pods"]):
        assert tf.encode_pod_blob(p) == jf.encode_pod_blob(q)
        assert tserde.encode_pod(tf.decode_pod_blob(jf.encode_pod_blob(q))) \
            == jserde.encode_pod(q)


# ------------------------------------------------------- typed failures


def _err(fn, f):
    try:
        out = fn(f)
    except f.FrameError as e:
        return ("FrameError", str(e))
    return ("ok", repr(out))


FAILURES = {
    "corrupt_length_ascii": lambda f: f.FrameDecoder().feed(
        b"GET / HTTP/1.1\r\n\r\n"),
    "length_below_header": lambda f: f.FrameDecoder().feed(
        struct.pack("!IBBI", 2, f.PING, 0, 1)),
    "oversized": lambda f: f.FrameDecoder(max_frame=64).feed(
        f.encode_frame(f.ERROR, 1, f.encode_error("y" * 200))),
    "truncated_verdict": lambda f: f.decode_verdict(b"\x00\x01"),
    "truncated_bind": lambda f: f.decode_bind_request(
        f.encode_bind_request("a", "ns", "u", "n")[:-3]),
    "truncated_admit_result": lambda f: f.decode_admit_result(b"\x00" * 5),
    "string_past_payload": lambda f: f.Reader(
        bytes(f.Writer().u32(1 << 30).buf)).str_(),
    "absurd_list_count": lambda f: f.Reader(
        bytes(f.Writer().u32(1 << 31).buf)).strs(),
    "empty_pod_blob": lambda f: f.decode_pod_blob(b""),
    "unknown_pod_codec": lambda f: f.decode_pod_blob(b"\x77{}"),
    "bad_json_pod_blob": lambda f: f.decode_pod_blob(
        bytes([f.CODEC_JSON]) + b"{nope"),
    "empty_items_blob": lambda f: f.decode_items_blob(b"", "pods"),
    "bad_json_items_blob": lambda f: f.decode_items_blob(
        bytes([f.CODEC_JSON]) + b"[{", "nodes"),
    "bad_stats": lambda f: f.decode_stats_result(
        bytes(f.Writer().blob(b"{x").buf)),
    "bad_cell_agg": lambda f: f.decode_cell_agg_result(
        bytes(f.Writer().blob(b"nope").blob(b"").buf)),
    "truncated_frame_waits": lambda f: f.FrameDecoder().feed(
        f.encode_frame(f.BIND, 5,
                       f.encode_bind_request("a", "ns", "u", "n"))[:-3]),
}


@pytest.mark.parametrize("case", sorted(FAILURES))
def test_failures_typed_the_same_way(case):
    got, want = _err(FAILURES[case], tf), _err(FAILURES[case], jf)
    assert got == want
    if case != "truncated_frame_waits":
        assert got[0] == "FrameError"


def test_decoder_reassembles_byte_by_byte_like_the_reference():
    wp = _world(PORT)
    frames = [
        tf.encode_frame(tf.PING, 1),
        tf.encode_frame(tf.FILTER, 2,
                        tf.encode_filter_request(wp["pods"][0], 8, 100),
                        flags=tf.FLAG_COMPACT),
        tf.encode_frame(tf.ERROR, 3, tf.encode_error("x" * 300)),
    ]
    stream = b"".join(frames)
    got = {}
    for f in (tf, jf):
        dec, out = f.FrameDecoder(), []
        for i in range(len(stream)):
            out.extend(dec.feed(stream[i:i + 1]))
        assert dec.buffered == 0
        got[f] = out
    assert got[tf] == got[jf]
    assert [(v, r) for v, _f, r, _p in got[tf]] == [
        (tf.PING, 1), (tf.FILTER, 2), (tf.ERROR, 3)]


def test_random_garbage_fails_the_same_way_in_both():
    """The fuzz core, held against the reference: the same byte soup
    gives the same frames, the same wait, or the same FrameError, and
    parsing any claimed payload stays typed the same way."""
    rng = random.Random(0xF022)
    for _trial in range(200):
        blob = bytes(rng.randrange(256)
                     for _ in range(rng.randrange(1, 400)))
        out = {}
        for f in (tf, jf):
            dec = f.FrameDecoder(max_frame=1 << 16)
            try:
                frames = dec.feed(blob)
            except f.FrameError as e:
                out[f] = ("FrameError", str(e))
                continue
            parsed = []
            for _v, _fl, _r, payload in frames:
                for parse in ("decode_verdict", "decode_bind_request",
                              "decode_filter_request", "decode_admit_result"):
                    parsed.append(_err(lambda m: getattr(m, parse)(payload),
                                       f)[0])
            out[f] = (frames, dec.buffered, parsed)
        assert out[tf] == out[jf]
