"""The seeded generator: each configuration's stream parses with the
port's parser, lands on its configuration's bytes a picture on seed 0,
and the reference decodes it to the generator's own reconstruction."""

import numpy as np
import pytest

from jsvbench import encoder, manifest, streams
from jsvbench.harness import decode_key, gops_of
from jsvbench.reference import oracle, refmath
from jsvx_torch.pipeline.packed_parse import walk_stream

CONFIGS = {c["name"]: manifest.read_json(c["file"])
           for c in manifest.load()["configs"]}


def coded(config, seed, j):
    h, w, n = int(config["height"]), int(config["width"]), int(
        config["gop_size"])
    frames, motion = streams.clip(h, w, n, seed,
                                  float(config["generator"]["noise"]),
                                  t0=j * n)
    frames = [tuple(streams.pad_to_coded(p, 16 if i == 0 else 8)
                    for i, p in enumerate(f)) for f in frames]
    return encoder.encode_gop(frames, motion, streams.params_of(config),
                              target_bytes=float(config["bytes_per_picture"]))


@pytest.mark.parametrize("j", [0, 1])
@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_stream_of_each_configuration(name, j, tmp_path):
    """GOP j of each configuration's seed-0 clip."""
    config = CONFIGS[name]
    payloads, recons, qs = coded(config, 0, j)
    mean = np.mean([len(p) for p in payloads])
    assert abs(mean / config["bytes_per_picture"] - 1) < 0.03, mean
    assert qs[0] == config["generator"]["quantizer_scale"]
    data = encoder.assemble(config["width"], config["height"],
                            streams.params_of(config), [payloads] * 3)
    meta, seq, groups = walk_stream(data)
    assert (meta.width, meta.height) == (config["width"], config["height"])
    assert seq.coded_height == config["coded_height"]
    assert [len(g) for g in groups] == [config["gop_size"]] * 3
    gops = gops_of(data)
    assert len({decode_key(g) for g in gops}) == 1
    decoded = oracle.decode_gop(decode_key(gops[1]))
    assert len(decoded) == len(recons)
    for got, want in zip(decoded, recons):
        for a, b in zip(got, want):
            np.testing.assert_array_equal(a, b)


def test_rate_and_cache_per_seed(tmp_path):
    config = CONFIGS["vcd-sif"]
    store = streams.Streams("vcd-sif", config, str(tmp_path))
    for seed in (1, 2 ** 31 + 5):
        data, spent = store.stream(seed, 2)
        assert spent > 0
        again, spent = store.stream(seed, 2)
        assert again == data and spent == 0
        mean = np.mean([len(p) for p in store.gop(seed)[0]])
        assert abs(mean / config["bytes_per_picture"] - 1) < 0.03
    assert store.stream(3, 1)[0] != store.stream(4, 1)[0]


def test_neighbouring_gops_differ(tmp_path):
    """A stream repeats the seed's distinct GOPs in turn, so each GOP's
    neighbours carry other pictures; each GOP is the same whichever was
    made first."""
    config = CONFIGS["vcd-sif"]
    store = streams.Streams("vcd-sif", config, str(tmp_path))
    data, _ = store.stream(-7, 5)
    keys = [decode_key(g) for g in gops_of(data)]
    d = config["distinct_gops"]
    assert d >= 2 and len(set(keys)) == d
    assert keys == [keys[i % d] for i in range(5)]
    again = streams.Streams("vcd-sif", config, str(tmp_path / "b"))
    assert again.gop(-7, 1)[0] == store.gop(-7, 1)[0]


def test_prediction_over_planes_equals_the_block_loop():
    rng = np.random.default_rng(0)
    ref = rng.integers(0, 256, (64, 96)).astype(np.float64)
    mv = rng.integers(-9, 10, (4, 6, 2))
    mask = rng.random((4, 6)) > 0.2
    for size, one in ((16, refmath.mc_luma_block),
                      (8, refmath.mc_chroma_block)):
        plane = ref[:4 * size, :6 * size]
        got = oracle.predict_plane(plane, mv, mask, size)
        for r in range(4):
            for c in range(6):
                want = one(plane, r, c, mv[r, c]) if mask[r, c] else 0
                np.testing.assert_array_equal(
                    got[r * size:(r + 1) * size, c * size:(c + 1) * size],
                    want)
