"""The frozen work and bound arithmetic equals ``chip_smoke.py``'s on a
small stream: the benchmark's from the reference parser's products,
chip_smoke's from the port's parse of the same bytes."""

import numpy as np
import pytest
import torch

import chip_smoke
from jsvbench import encoder, streams, work
from jsvbench.reference import oracle
from jsvx_torch.pipeline.gop import frame_at
from jsvx_torch.pipeline.packed_parse import (BufferPool, parse_gop_compact,
                                              parse_gop_packed, walk_stream)
from jsvx_torch.pipeline.wire import flatten_wire, unflatten_wire, wire_spec

H, W, N = 96, 128, 5


@pytest.fixture(scope="module")
def stream():
    frames, motion = streams.clip(H, W, N, 8, 3.0)
    p = encoder.EncodeParams(quantizer_scale=6)
    payloads, _, _ = encoder.encode_gop(frames, motion, p)
    data = encoder.assemble(W, H, p, [payloads])
    fts = []
    oracle.decode_gop(streams_gop(data), keep=fts)
    return data, fts


def streams_gop(data):
    from jsvbench.harness import gops_of
    return gops_of(data)[0]


def to_torch(stacked):
    spec = wire_spec(stacked)
    return unflatten_wire(torch.from_numpy(flatten_wire(stacked, spec)),
                          spec)


def test_picture_and_two_kernel_work(stream):
    data, fts = stream
    arr = np.frombuffer(data, np.uint8)
    meta, seq, groups = walk_stream(data)
    dense = to_torch(parse_gop_packed(arr, groups[0], seq, meta).stacked)
    assert len(fts) == N
    for i, ft in enumerate(fts):
        frame = frame_at(dense, i)
        assert work.picture_work(ft) == chip_smoke.picture_work(frame)
        assert work.two_kernel_work(ft) == chip_smoke.two_kernel_work(frame)
    assert any(w["bytes"] < w["bytes_all_levels"]
               for w in map(work.picture_work, fts))


def test_expand_work(stream):
    data, fts = stream
    arr = np.frombuffer(data, np.uint8)
    meta, seq, groups = walk_stream(data)
    g = parse_gop_compact(arr, groups[0], seq, meta, BufferPool(), {})
    assert not g.dirty
    tree = to_torch(g.stacked)
    assert work.expand_work(fts, seq.mb_height, seq.mb_width) == \
        chip_smoke.expand_work(tree, seq.mb_height, seq.mb_width)


@pytest.mark.parametrize("h,w", [(1080, 1920), (1088, 1920), (240, 352),
                                 (95, 127)])
def test_colour_work_and_bound(h, w):
    assert work.colour_work(h, w) == chip_smoke.colour_work(h, w)
    assert work.bound(*work.colour_work(h, w)) == \
        chip_smoke.bound(*chip_smoke.colour_work(h, w))
    assert (work.HBM_BYTES_PER_S, work.F32_FLOP_PER_S) == \
        (chip_smoke.HBM_BYTES_PER_S, chip_smoke.F32_FLOP_PER_S)


def test_window_merges_device_intervals():
    assert work.merge([(5, 7), (0, 2), (1, 3), (7, 9)]) == [[0, 3], [5, 9]]
    w = work.Window(True)
    w.start, w.end = 0, 10_000_000_000
    w.device_intervals = [(1e9, 2e9), (1.5e9, 3e9), (8e9, 12e9)]
    w.kernels = {"a_kernel": [1.5, 3], "b": [0.5, 1]}
    w.spans = [("transcode", 0, 10e9), ("sink", 3.5e9, 7.5e9)]
    assert w.busy_s == pytest.approx(4.0)
    assert w.kernel("kernel") == (1.5, 3)
    b = w.breakdown()
    assert b["device_ops"][0] == ["a_kernel", 1.5]
    assert b["idle_gaps"][0] == ["sink", pytest.approx(5.0)]


def test_bounds_of_a_gop_over_a_whole_stream(tmp_path):
    """The bounds a GOP are the mean over the stream's alternating GOPs,
    with a whole number of pictures, so a roofline's launch count (one a
    picture) can match the trace exactly."""
    from jsvbench import manifest
    from jsvbench.harness import Reference

    _, _, w, config = manifest.load_cell("vcd-sif.transcode")
    store = streams.Streams("vcd-sif", config, str(tmp_path))
    gops = int(w["gops_per_stream"])
    data, _ = store.stream(3, gops)
    ref = Reference(store, 3, data, config)
    b = ref.work()
    assert b["pictures_per_gop"] == config["gop_size"]
    assert 170 * b["pictures_per_gop"] == 170 * config["gop_size"]
    per = [ref._of(g)[1]["fused_s_per_gop"] for g in range(2)]
    assert per[0] != per[1]
    assert b["fused_s_per_gop"] == pytest.approx(sum(per) / 2)
