"""The compact wire's expansion (jsvx_torch.kernels.expand) vs jsvx's.

The expansion is integer, so everything here is bit-equal:

* a numpy mirror of the expansion kernel's partition (``csrc/expand.cu``):
  CTA tiles of ``TILE_BLOCKS`` blocks, each tile's base from the counts of
  the blocks before it, the tile's own scan, the thread -> block map and
  each block's [start, end); it gives every entry of the wire the block
  that jsvx's rank gives it (``jsvx/kernels/expand.py:67-73``);
* the mirror's expansion == jsvx's ``expand_levels`` and
  ``expand_compact_gop`` on every leaf, and so does the port's wrapper on
  the CPU (its plain version);
* the cases: zero-count blocks, empty frames and an empty GOP, 64-entry
  blocks, tiles that end mid-frame and mid-row of macroblocks, bucket
  padding and n > sum(counts), YUVA, and the wires of the 1080p, CIF and
  320x320 shapes (encoded streams where a CPU encode is quick).

The kernel itself (CUDA C++ for sm_90a) runs only on a card, in the
``cuda``-marked test (the synthetic GOPs and the streams of
``tests/torch_card.py``):
``python -m pytest tests/test_torch_expand.py -m cuda --noconftest``.
"""

import os
import shutil

import numpy as np
import pytest
import torch

try:                                     # the card's machine has no JAX
    import jax
    import jax.numpy as jnp

    from jsvx.kernels import expand as jexpand

    # jitted as jsvx's GOP program compiles them (one program per shape)
    j_expand_levels = jax.jit(jexpand.expand_levels, static_argnums=(3, 4, 5))
    j_expand_gop = jax.jit(jexpand.expand_compact_gop, static_argnums=(1, 2))
except ImportError:
    jnp = None

from jsvx_torch.kernels import build, expand
from jsvx_torch.pipeline.packed_parse import (BufferPool, parse_gop_compact,
                                              walk_stream)
from jsvx_torch.pipeline.wire import flatten_wire, unflatten_wire, wire_spec
from jsvx_torch.tools import EncoderConfig, JsvEncoder
from jsvx_torch.tools.fixture import zoom_clip

import torch_card

torch.set_num_threads(1)

TILE = expand.TILE_BLOCKS
COMPS = ("y", "cb", "cr", "a")
needs_jax = pytest.mark.skipif(jnp is None, reason="needs jax")


# ---------------------------------------------------------------------------
# The kernel's partition and expansion, in numpy

def block_origin(wb, n_blocks: int, mb_w: int, luma_like: bool):
    """Wire-order block indices -> (frame, block row, block column, MB of
    the frame): the kernel's index math."""
    wb = np.asarray(wb, np.int64)
    frame = wb // n_blocks
    r = wb - frame * n_blocks
    if luma_like:
        mb = r >> 2
        mby = mb // mb_w
        return frame, mby * 2 + ((r >> 1) & 1), (mb - mby * mb_w) * 2 + (
            r & 1), mb
    return frame, r // mb_w, r % mb_w, r


def block_ranges(counts: np.ndarray, n_coef: int, n_ent: int,
                 luma_like: bool) -> tuple:
    """Each block's entries [lo, hi), in wire order, as the kernel's CTAs
    compute them: per tile the sum of the counts before it (its base) and
    the exclusive scan of its own counts; the thread of each block reads
    its start and the next one, both capped at min(n, bucket); the last
    block of the component takes every entry up to that cap."""
    flat = counts.reshape(-1).astype(np.int64)
    n_total = flat.size
    limit = min(int(n_coef), n_ent)
    lo = np.zeros(n_total, np.int64)
    hi = np.zeros(n_total, np.int64)
    threads = np.asarray(expand.thread_blocks(luma_like), np.int64)
    (begin,), ctas = expand.expand_layout([n_total])
    assert begin == 0
    for tile in range(ctas):
        t0 = tile * TILE
        base = int(flat[:t0].sum())
        own = np.zeros(TILE, np.int64)
        m = min(TILE, n_total - t0)
        own[:m] = flat[t0:t0 + m]
        start = base + np.concatenate([[0], np.cumsum(own)])
        wb = t0 + threads
        live = wb < n_total
        wl, wb = threads[live], wb[live]
        top = np.minimum(start[wl + 1], limit)
        lo[wb] = np.minimum(start[wl], max(limit, 0))
        hi[wb] = np.where(wb == n_total - 1, limit, top)
    return lo, hi


def owner_of_entries(lo: np.ndarray, hi: np.ndarray, n_ent: int):
    """The block each entry goes to under the partition (-1: dropped), and
    the entries in the order the threads write them."""
    sizes = np.maximum(hi - lo, 0)
    blocks = np.repeat(np.arange(lo.size), sizes)
    first = np.repeat(lo - (np.cumsum(sizes) - sizes), sizes)
    ent = np.arange(sizes.sum()) + first
    owner = np.full(n_ent, -1, np.int64)
    assert np.all(np.bincount(ent, minlength=n_ent) <= 1), "shared entry"
    owner[ent] = blocks
    return owner, ent, blocks


def jsvx_rank(counts: np.ndarray, n_coef: int, n_ent: int) -> np.ndarray:
    """jsvx's entry -> block (jsvx/kernels/expand.py:67-73) in numpy, -1
    for the dropped entries (index >= n)."""
    flat = counts.reshape(-1).astype(np.int64)
    marks = np.zeros(n_ent + 1, np.int64)
    np.add.at(marks, np.minimum(np.cumsum(flat), n_ent), 1)
    blk = np.minimum(np.cumsum(marks[:n_ent]), flat.size - 1)
    return np.where(np.arange(n_ent) < n_coef, blk, -1)


def mirror_levels(cpk: np.ndarray, n_coef: int, counts: np.ndarray,
                  mb_h: int, mb_w: int, luma_like: bool) -> np.ndarray:
    """The kernel's levels: every block from its own entries, in wire
    order (a later entry wins a repeated position)."""
    n, n_blocks = counts.shape
    rep = 2 if luma_like else 1
    h, w = mb_h * rep * 8, mb_w * rep * 8
    lo, hi = block_ranges(counts, n_coef, cpk.size, luma_like)
    _, ent, blocks = owner_of_entries(lo, hi, cpk.size)
    frame, by, bx, _ = block_origin(blocks, n_blocks, mb_w, luma_like)
    e = cpk[ent].astype(np.int64)
    pos = e >> 10
    plane = np.zeros((n, h, w), np.int16)
    plane[frame, by * 8 + (pos >> 3), bx * 8 + (pos & 7)] = (
        (e & 1023) - 512).astype(np.int16)
    return plane


def mirror_gop(stacked: dict, mb_h: int, mb_w: int) -> dict:
    """The kernel's whole output for a GOP, with the wire's chroma grids."""
    mb = stacked["mb"]
    n = mb["q"].shape[0]
    out = {"is_p": stacked["is_p"], "f_code": stacked["f_code"]}
    for key in COMPS:
        if key not in stacked["coef"]:
            continue
        luma = key in ("y", "a")
        rep = 2 if luma else 1
        c = stacked["coef"][key]

        def up(a):
            return np.repeat(np.repeat(a, rep, 1), rep, 2)

        out[key] = dict(
            levels=mirror_levels(c["cpk"], int(c["n"]), c["counts"], mb_h,
                                 mb_w, luma),
            lnz=np.full((n, mb_h * rep, mb_w * rep), 64, np.uint8),
            q=up(mb["q"]), intra=up(mb["intra"]), mv=up(mb["mv"]),
            rep_add=up(mb["rep_add"]))
    return out


# ---------------------------------------------------------------------------
# Wires

def synthetic_gop(seed: int, n: int, mb_h: int, mb_w: int,
                  yuva: bool = False, mean: float = 6.0, pad: int = 40,
                  extra: int = 0, empty_frames=(), full: float = 0.02
                  ) -> dict:
    """A compact wire dict (numpy, the parser's layout) from a seed: per
    block a count (zeros common, 64 in about ``full`` of blocks) and that
    many distinct positions with levels in [-512, 511]; ``empty_frames``
    code nothing; the bucket has ``pad`` garbage entries past the last
    block, the first ``extra`` of them inside n (n > sum(counts)), at
    positions the last block does not use."""
    rng = np.random.default_rng(seed)
    coef = {}
    for key in COMPS[:4 if yuva else 3]:
        luma = key in ("y", "a")
        nb = expand.comp_blocks(mb_h, mb_w, luma)
        counts = np.minimum(rng.poisson(mean, (n, nb)), 63)
        counts[rng.random((n, nb)) < 0.3] = 0
        counts[rng.random((n, nb)) < full] = 64
        for f in empty_frames:
            counts[f] = 0
        counts = counts.astype(np.uint8)
        flat = counts.reshape(-1).astype(np.int64)
        if extra and flat.size:
            flat[-1] = counts.reshape(-1)[-1] = min(flat[-1], 60)
        total = int(flat.sum())
        # distinct positions per block: (a + j * s) mod 64, s odd
        a = np.repeat(rng.integers(0, 64, flat.size), flat)
        s = np.repeat(rng.integers(0, 32, flat.size) * 2 + 1, flat)
        j = np.arange(total) - np.repeat(np.cumsum(flat) - flat, flat)
        pos = (a + j * s) & 63
        lvl = rng.integers(-512, 512, total)
        tail_pos = np.setdiff1d(np.arange(64), pos[total - flat[-1]:]
                                if flat.size else [])[:extra]
        assert tail_pos.size == extra
        junk = rng.integers(0, 1 << 16, pad)
        junk[:extra] = (tail_pos << 10) | rng.integers(0, 1024, extra)
        cpk = np.concatenate([(pos << 10) | (lvl + 512), junk]).astype(
            np.uint16)
        coef[key] = dict(cpk=cpk, n=np.int32(total + extra), counts=counts)
    mb = dict(q=rng.integers(1, 32, (n, mb_h, mb_w)).astype(np.uint8),
              intra=(rng.random((n, mb_h, mb_w)) < 0.3).astype(np.uint8),
              rep_add=(rng.random((n, mb_h, mb_w)) < 0.2).astype(np.uint8),
              mv=rng.integers(-64, 64, (n, mb_h, mb_w, 2)).astype(np.int16))
    return dict(is_p=(np.arange(n) > 0).astype(np.int32),
                f_code=np.full(n, 2, np.int32), mb=mb, coef=coef)


def yuva_clip(n: int, h: int, w: int) -> list:
    yy, xx = np.mgrid[0:h, 0:w]
    return [(y, cb, cr, np.clip(128 + 80 * np.sin(2 * np.pi * (xx + 5 * t)
                                                   / w) + 40 * (yy > 4 * t),
                                0, 255).astype(np.uint8))
            for t, (y, cb, cr) in enumerate(zoom_clip(h, w, n, seed=5))]


def encoded_gops(clip, **cfg) -> list:
    """(stacked compact wire as numpy, mb_h, mb_w) of every GOP of the
    port's encoding of ``clip``, through the port's C++ parse."""
    h, w = clip[0][0].shape
    data = JsvEncoder(w, h, EncoderConfig(**cfg)).encode(clip)
    arr = np.frombuffer(data, np.uint8)
    meta, seq, groups = walk_stream(data)
    out, buckets = [], {}
    for gi in range(len(groups)):
        g = parse_gop_compact(arr, groups[gi], seq, meta, BufferPool(),
                              buckets, index=gi)
        assert not g.dirty
        out.append((g.stacked, seq.mb_height, seq.mb_width))
    return out


#: synthetic wires: (seed, frames, mb_h, mb_w, keywords)
SYNTHETIC = {
    "one_mb": (1, 3, 1, 1, {}),
    "mid_frame_tiles": (2, 9, 3, 5, {}),
    "chroma_tiles_over_frames": (3, 20, 3, 5, dict(mean=2.0)),
    "empty_frames": (4, 6, 4, 7, dict(empty_frames=(0, 3))),
    "all_empty": (5, 3, 2, 3, dict(mean=0.0, full=0.0)),
    "full_blocks": (6, 2, 2, 9, dict(full=0.5)),
    "n_past_sum": (7, 4, 3, 4, dict(extra=3)),
    "empty_gop": (8, 0, 2, 3, {}),
    "yuva": (9, 5, 3, 6, dict(yuva=True, extra=2)),
    "cif_shape": (10, 3, 18, 22, dict(mean=8.0)),
    "320x320_shape": (11, 2, 20, 20, dict(mean=10.0)),
    "1080p_shape": (12, 4, 68, 120, dict(mean=12.0, pad=5000)),
}


@pytest.fixture(scope="module")
def encoded():
    """The encoded wires: CIF, 320x320, and a YUVA 128x96 stream."""
    return {
        "cif": encoded_gops(zoom_clip(288, 352, 4, seed=7), gop_size=2,
                            quantizer_scale=6, me_range=4),
        "320x320": encoded_gops(zoom_clip(320, 320, 3, seed=11),
                                gop_size=3, quantizer_scale=4, me_range=4),
        "yuva": encoded_gops(yuva_clip(4, 96, 128), gop_size=2,
                             quantizer_scale=5, me_range=4),
    }


def _torch_tree(tree: dict, device="cpu") -> dict:
    return {k: _torch_tree(v, device) if isinstance(v, dict)
            else torch.from_numpy(np.array(v)).to(device)
            for k, v in tree.items()}


def _jax_tree(tree: dict) -> dict:
    return {k: _jax_tree(v) if isinstance(v, dict) else jnp.asarray(v)
            for k, v in tree.items()}


def _leaves(tree, path=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, path + (k,))
        else:
            yield path + (k,), v


def _assert_trees_equal(got: dict, want: dict) -> None:
    got, want = dict(_leaves(got)), dict(_leaves(want))
    assert got.keys() == want.keys()
    for path, g in got.items():
        g, w = (v.cpu().numpy() if isinstance(v, torch.Tensor)
                else np.asarray(v) for v in (g, want[path]))
        assert g.shape == w.shape and g.dtype == w.dtype, path
        assert np.array_equal(g, w), path


def _comp_cases(stacked: dict, mb_h: int, mb_w: int):
    for key, c in stacked["coef"].items():
        yield (c["cpk"], int(c["n"]), c["counts"], mb_h, mb_w,
               key in ("y", "a"))


# ---------------------------------------------------------------------------
# The partition

def test_thread_blocks_cover_each_tile_block_once():
    for luma in (False, True):
        blocks = expand.thread_blocks(luma)
        assert sorted(blocks) == list(range(TILE))
    luma = expand.thread_blocks(True)
    # a warp's threads: side by side in one block row of the tile's MBs
    for warp in range(TILE // 32):
        sub = luma[warp * 32:(warp + 1) * 32]
        assert {(b >> 1) & 1 for b in sub} == {int(warp >= 4)}
        assert [b >> 2 for b in sub] == sorted(
            [m for m in range((warp % 4) * 16, (warp % 4) * 16 + 16)] * 2)


def test_expand_layout_of_1080p():
    """A 1080p GOP of 4 frames: 4 x 32640 luma blocks in 510 tiles, and
    4 x 8160 blocks of each chroma in 128 (the last one half full)."""
    totals = [4 * expand.comp_blocks(68, 120, luma)
              for luma in (True, False, False)]
    assert totals == [130560, 32640, 32640]
    assert expand.expand_layout(totals) == ((0, 510, 638), 766)
    assert expand.expand_layout([0, 0]) == ((0, 0), 0)


def test_layout_constants_match_the_kernel():
    with open(os.path.join(build.CSRC, "expand.cu")) as f:
        text = f.read()
    assert f"constexpr int kTileBlocks = {expand.TILE_BLOCKS};" in text
    assert f"constexpr int kMaxComps = {expand.MAX_COMPS};" in text
    # luma tiles hold whole MBs, so a tile never splits one
    assert TILE % 4 == 0


@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_partition_gives_jsvx_rank(name):
    seed, n, mb_h, mb_w, kw = SYNTHETIC[name]
    stacked = synthetic_gop(seed, n, mb_h, mb_w, **kw)
    for cpk, n_coef, counts, _, _, luma in _comp_cases(stacked, mb_h, mb_w):
        lo, hi = block_ranges(counts, n_coef, cpk.size, luma)
        owner, _, _ = owner_of_entries(lo, hi, cpk.size)
        want = jsvx_rank(counts, n_coef, cpk.size)
        if counts.size == 0:              # no block to own anything
            assert np.all(owner == -1)
            continue
        assert np.array_equal(owner, want)
        # the tiles' bases are the blocks' own prefix sums (capped)
        flat = counts.reshape(-1).astype(np.int64)
        starts = np.cumsum(flat) - flat
        assert np.array_equal(lo, np.minimum(starts, min(n_coef, cpk.size)))


@needs_jax
@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_mirror_equals_jsvx_expand_levels(name):
    seed, n, mb_h, mb_w, kw = SYNTHETIC[name]
    stacked = synthetic_gop(seed, n, mb_h, mb_w, **kw)
    for case in _comp_cases(stacked, mb_h, mb_w):
        cpk, n_coef, counts, mb_h, mb_w, luma = case
        want = np.asarray(j_expand_levels(
            jnp.asarray(cpk), jnp.int32(n_coef), jnp.asarray(counts), mb_h,
            mb_w, luma))
        got = mirror_levels(*case)
        assert got.dtype == want.dtype and np.array_equal(got, want), luma
        port = expand.expand_levels(
            torch.from_numpy(cpk), torch.tensor(n_coef, dtype=torch.int32),
            torch.from_numpy(counts), mb_h, mb_w, luma)
        assert np.array_equal(port.numpy(), want)


@needs_jax
@pytest.mark.parametrize("name", sorted(SYNTHETIC))
def test_mirror_and_port_equal_jsvx_expand_compact_gop(name):
    seed, n, mb_h, mb_w, kw = SYNTHETIC[name]
    stacked = synthetic_gop(seed, n, mb_h, mb_w, **kw)
    want = j_expand_gop(_jax_tree(stacked), mb_h, mb_w)
    _assert_trees_equal(mirror_gop(stacked, mb_h, mb_w), want)
    _assert_trees_equal(expand.expand_compact_gop(_torch_tree(stacked),
                                                  mb_h, mb_w), want)


@needs_jax
@pytest.mark.parametrize("stream", ["cif", "320x320", "yuva"])
def test_encoded_wires_equal_jsvx(encoded, stream):
    """Every GOP of an encoded stream through the port's wire (flatten,
    unflatten): the partition gives jsvx's rank, and the mirror and the
    port's expansion equal jsvx's on every leaf."""
    for stacked, mb_h, mb_w in encoded[stream]:
        spec = wire_spec(stacked)
        tree = unflatten_wire(torch.from_numpy(flatten_wire(stacked, spec)),
                              spec)
        for cpk, n_coef, counts, _, _, luma in _comp_cases(stacked, mb_h,
                                                           mb_w):
            lo, hi = block_ranges(counts, n_coef, cpk.size, luma)
            assert np.array_equal(owner_of_entries(lo, hi, cpk.size)[0],
                                  jsvx_rank(counts, n_coef, cpk.size))
        want = j_expand_gop(_jax_tree(stacked), mb_h, mb_w)
        assert len(stacked["coef"]) == (4 if stream == "yuva" else 3)
        _assert_trees_equal(mirror_gop(stacked, mb_h, mb_w), want)
        _assert_trees_equal(expand.expand_compact_gop(tree, mb_h, mb_w),
                            want)


def test_unflatten_gives_views_of_the_wire(encoded):
    """Every leaf the expansion reads is a view of the one wire tensor (no
    copy, so nothing runs between the wire's copy and the launch)."""
    stacked, _, _ = encoded["yuva"][0]
    spec = wire_spec(stacked)
    buf = torch.from_numpy(flatten_wire(stacked, spec))
    lo, hi = buf.data_ptr(), buf.data_ptr() + buf.numel()
    leaves = dict(_leaves(unflatten_wire(buf, spec)))
    assert len(leaves) == 2 + 4 + 3 * 4
    for path, t in leaves.items():
        assert t.untyped_storage().data_ptr() == lo, path
        assert lo <= t.data_ptr() < hi and t.is_contiguous(), path
        assert t.data_ptr() % 16 == 0, path      # counts: 16-byte loads


@needs_jax
def test_repeated_positions_with_equal_values():
    """A block whose entries repeat a position (with one value: the order
    of jsvx's scatter over repeats is not fixed) and padding entries that
    would land on it: one write survives."""
    cpk = np.full(10, (17 << 10) | (3 + 512), np.uint16)
    counts = np.array([[0, 4, 0, 2]], np.uint8)
    for n_coef in (6, 8):
        want = np.asarray(j_expand_levels(jnp.asarray(cpk), jnp.int32(n_coef),
                                          jnp.asarray(counts), 1, 1, True))
        got = mirror_levels(cpk, n_coef, counts, 1, 1, True)
        assert np.array_equal(got, want) and got.sum() == 6


# ---------------------------------------------------------------------------
# The wrapper

def test_wrapper_on_the_cpu_is_the_plain_version():
    stacked = _torch_tree(synthetic_gop(20, 3, 3, 4, yuva=True))
    before = (expand.launches, expand.plain_calls)
    got = expand.expand_compact_gop(stacked, 3, 4)
    assert (expand.launches, expand.plain_calls) == (before[0],
                                                     before[1] + 4)
    _assert_trees_equal(got, expand.expand_compact_gop_plain(stacked, 3, 4))
    c = stacked["coef"]["cb"]
    lv = expand.expand_levels(c["cpk"], c["n"], c["counts"], 3, 4, False)
    assert expand.launches == before[0]
    assert torch.equal(lv, got["cb"]["levels"])
    # chroma keeps the wire's per-MB grids
    assert got["cb"]["q"] is stacked["mb"]["q"]


def _meta(stacked: dict) -> dict:
    return _torch_tree(stacked, "meta")


def test_wrapper_rejects_other_devices():
    stacked = _meta(synthetic_gop(21, 2, 2, 3))
    with pytest.raises(ValueError, match="no expansion kernel"):
        expand.expand_compact_gop(stacked, 2, 3)
    c = stacked["coef"]["y"]
    with pytest.raises(ValueError, match="no expansion kernel"):
        expand.expand_levels(c["cpk"], c["n"], c["counts"], 2, 3, True)


def _bad(change) -> dict:
    stacked = _meta(synthetic_gop(22, 2, 2, 3))
    change(stacked)
    return stacked


def _set(path, value):
    def change(tree):
        node = tree
        for k in path[:-1]:
            node = node[k]
        node[path[-1]] = value(node[path[-1]])
    return change


REJECTED = {
    "cpk_int16": (_set(("coef", "y", "cpk"), lambda t: t.view(torch.int16)),
                  TypeError),
    "cpk_2d": (_set(("coef", "cb", "cpk"), lambda t: t[None]), ValueError),
    "n_int64": (_set(("coef", "y", "n"), lambda t: t.to(torch.int64)),
                TypeError),
    "n_two": (_set(("coef", "y", "n"), lambda t: t.reshape(1).repeat(2)),
              ValueError),
    "counts_int16": (_set(("coef", "cr", "counts"),
                          lambda t: t.to(torch.int16)), TypeError),
    "counts_chroma_shape": (_set(("coef", "cr", "counts"),
                                 lambda t: t.repeat(1, 4)), ValueError),
    "counts_frames": (_set(("coef", "y", "counts"), lambda t: t[:1]),
                      ValueError),
    "counts_strided": (_set(("coef", "y", "counts"),
                            lambda t: t.t().contiguous().t()), ValueError),
    "q_int16": (_set(("mb", "q"), lambda t: t.to(torch.int16)), TypeError),
    "mv_int32": (_set(("mb", "mv"), lambda t: t.to(torch.int32)),
                 TypeError),
    "rep_add_shape": (_set(("mb", "rep_add"), lambda t: t[:, :1]),
                      ValueError),
    "intra_on_cpu": (_set(("mb", "intra"), lambda t: torch.zeros(
        t.shape, dtype=t.dtype)), ValueError),
}


@pytest.mark.parametrize("case", sorted(REJECTED))
def test_wrapper_rejects_bad_inputs(case):
    change, error = REJECTED[case]
    with pytest.raises(error):
        expand.expand_compact_gop(_bad(change), 2, 3)


def test_too_many_components_rejected():
    stacked = _meta(synthetic_gop(23, 1, 1, 1, yuva=True))
    comps = [(stacked["coef"]["y"], True, True)] * 5
    with pytest.raises(ValueError, match="takes 1 to 4"):
        expand._launch(comps, stacked["mb"], 1, 1, 1, torch.device("meta"))


def test_build_key_tracks_the_expansion_source(tmp_path):
    """The kernels' library holds expand.cu and declares its entry point;
    an edit to it changes the library's key."""
    assert "expand.cu" in build.SOURCES
    assert "jsvx_expand_gop" in build.ENTRY_POINTS
    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    before = build._key(str(csrc))
    path = csrc / "expand.cu"
    orig = path.read_bytes()
    path.write_bytes(orig + b"\n// edited\n")
    assert build._key(str(csrc)) != before
    path.write_bytes(orig)
    assert build._key(str(csrc)) == before


# ---------------------------------------------------------------------------
# The card

def _card_trees(source, dev):
    """(name, wire on the card, mb_h, mb_w): every synthetic GOP, or every
    GOP of a stream of ``tests/torch_card.py`` (each on the compact
    wire)."""
    if source == "synthetic":
        for name in sorted(SYNTHETIC):
            seed, n, mb_h, mb_w, kw = SYNTHETIC[name]
            stacked = synthetic_gop(seed, n, mb_h, mb_w, **kw)
            spec = wire_spec(stacked)
            yield name, unflatten_wire(torch.from_numpy(
                flatten_wire(stacked, spec)).to(dev), spec), mb_h, mb_w
        return
    data = torch_card.stream(source)
    seq = walk_stream(data)[1]
    for gi, (compact, tree) in enumerate(torch_card.wires(data, dev)):
        assert compact, gi
        yield f"GOP {gi}", tree, seq.mb_height, seq.mb_width


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["synthetic", "1080p", "320x320-256mv",
                                    "cif-352x288", "yuva-128x96"])
def test_kernel_matches_plain_on_the_card(source):
    """One launch a GOP, every leaf equal to the plain version's (dtype,
    shape, values), and each component's one-component launch equal to
    the plain levels: the synthetic GOPs, and every GOP on the compact
    wire of the card's streams."""
    dev = torch_card.card()
    for name, tree, mb_h, mb_w in _card_trees(source, dev):
        n = int(tree["is_p"].shape[0])
        before = expand.launches
        got = expand.expand_compact_gop(tree, mb_h, mb_w)
        want = expand.expand_compact_gop_plain(tree, mb_h, mb_w)
        torch.cuda.synchronize()
        assert expand.launches == before + (n > 0), name
        _assert_trees_equal(got, want)
        for key, c in tree["coef"].items():
            luma = key in ("y", "a")
            lv = expand.expand_levels(c["cpk"], c["n"], c["counts"], mb_h,
                                      mb_w, luma)
            torch.cuda.synchronize()
            assert torch.equal(lv, want[key]["levels"]), (name, key)
