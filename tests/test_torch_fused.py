"""The fused decode kernel's wrapper, build command and JAX-free import.

On the CPU the wrapper runs the kernel's plain version; the kernel itself
(CUDA C++ for sm_90a) runs only on a card, in the ``cuda``-marked test,
on random inputs and on the encoded GOPs of ``tests/torch_card.py``.  On
a machine with a card and without JAX:
``python -m pytest tests/test_torch_fused.py -m cuda --noconftest``
(``tests/conftest.py`` imports JAX; this file needs none of it).
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from jsvx_torch.kernels import build, fused
from jsvx_torch.kernels.decode import (decode_frame_plane,
                                       decode_frame_planes, make_constants)

import torch_card

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _plane_inputs(h, w, seed):
    """Random per-block grids of one plane: dense levels, out-of-picture
    vectors, intra and intra-in-P blocks, partial scan ranges."""
    rng = np.random.default_rng(seed)
    hb, wb = h // 8, w // 8
    lv = rng.integers(-300, 300, (h, w)) * (rng.random((h, w)) < 0.3)
    c = dict(levels=lv.astype(np.int16),
             lnz=rng.integers(0, 65, (hb, wb)).astype(np.uint8),
             q=rng.integers(1, 32, (hb, wb)).astype(np.uint8),
             intra=(rng.random((hb, wb)) < 0.3).astype(np.uint8),
             mv=rng.integers(-70, 70, (hb, wb, 2)).astype(np.int16),
             rep_add=(rng.random((hb, wb)) < 0.1).astype(np.uint8))
    ref = rng.integers(0, 256, (h, w)).astype(np.uint8)
    return c, ref


def _on(c, ref, device):
    return ({k: torch.from_numpy(v).to(device) for k, v in c.items()},
            torch.from_numpy(ref).to(device))


CASES = [(h, w, chroma, is_p, quirk)
         for h, w, chroma in ((48, 64, False), (24, 40, True))
         for is_p in (0, 1) for quirk in (False, True)]


@pytest.mark.parametrize("h,w,chroma,is_p,quirk", CASES)
def test_wrapper_on_cpu_is_the_plain_version(h, w, chroma, is_p, quirk):
    c, ref = _plane_inputs(h, w, seed=h + w + is_p)
    tc, tref = _on(c, ref, "cpu")
    consts = make_constants(None, "cpu")
    ip = torch.tensor(is_p, dtype=torch.int32)
    before = fused.launches
    got = fused.fused_decode_plane(tc, tref, ip, consts, chroma, quirk)
    out = torch.full((h, w), 7, dtype=torch.uint8)
    got_out = fused.fused_decode_plane(tc, tref, ip, consts, chroma, quirk,
                                       out=out)
    want = decode_frame_plane(tc, tref, ip, consts, chroma, quirk)
    assert fused.launches == before
    assert got.dtype == torch.uint8 and got.shape == (h, w)
    assert torch.equal(got, want)
    assert got_out is out and torch.equal(out, want)


def test_frame_planes_on_cpu():
    c0, r0 = _plane_inputs(48, 64, 1)
    c1, r1 = _plane_inputs(24, 32, 2)
    c2, r2 = _plane_inputs(24, 32, 3)
    frame = {"is_p": torch.tensor(1, dtype=torch.int32)}
    refs = []
    for key, (c, r) in zip(("y", "cb", "cr"), ((c0, r0), (c1, r1),
                                                (c2, r2))):
        frame[key], ref = _on(c, r, "cpu")
        refs.append(ref)
    consts = make_constants(None, "cpu")
    got = fused.decode_frame_planes_fused(frame, tuple(refs), consts)
    want = decode_frame_planes(frame, tuple(refs), consts)
    assert len(got) == 3
    for g, w in zip(got, want):
        assert torch.equal(g, w)


def test_frame_planes_on_cpu_yuva():
    """Four planes (YUVA: the alpha plane full size, luma-like)."""
    frame = {"is_p": torch.tensor(1, dtype=torch.int32)}
    refs = []
    for key, (h, w), seed in zip(("y", "cb", "cr", "a"),
                                 ((48, 64), (24, 32), (24, 32), (48, 64)),
                                 (5, 6, 7, 8)):
        c, r = _plane_inputs(h, w, seed)
        frame[key], ref = _on(c, r, "cpu")
        refs.append(ref)
    consts = make_constants(None, "cpu")
    before = fused.launches
    got = fused.decode_frame_planes_fused(frame, tuple(refs), consts, True)
    want = decode_frame_planes(frame, tuple(refs), consts, True)
    assert fused.launches == before and len(got) == 4
    for g, w in zip(got, want):
        assert torch.equal(g, w)


#: the plane shapes of the pictures the port decodes: 1080p, CIF, 48x64,
#: the 320x320 256-vector stream, a 4-plane YUVA stream, and chroma planes
#: whose block count per row (22, 5, 1) is not a multiple of four
PICTURES = {
    "1080p": [(1088, 1920), (544, 960), (544, 960)],
    "cif": [(288, 352), (144, 176), (144, 176)],
    "48x64": [(48, 64), (24, 32), (24, 32)],
    "320x320": [(320, 320), (160, 160), (160, 160)],
    "yuva_96x128": [(96, 128), (48, 64), (48, 64), (96, 128)],
    "odd_chroma": [(48, 80), (24, 40), (24, 40)],
    "one_block_chroma": [(16, 16), (8, 8), (8, 8)],
}


@pytest.mark.parametrize("name", sorted(PICTURES))
def test_picture_layout_covers_every_block_once(name):
    """The per-picture descriptor packing of the three picture kernels
    (fused, MC, reconstruction): each plane's first CTA is the prefix sum
    of the CTA counts before it, every CTA finds its own plane, and the
    CTAs of a plane decode each of its 8x8 blocks exactly once, with no
    CTA left empty."""
    shapes = PICTURES[name]
    begins, total = fused.picture_layout(shapes)
    counts = [fused.plane_ctas(h, w) for h, w in shapes]
    assert list(begins) == [sum(counts[:i]) for i in range(len(shapes))]
    assert total == sum(counts)
    for p, (h, w) in enumerate(shapes):
        end = begins[p] + counts[p]
        assert all(fused.plane_of_cta(begins, cta) == p
                   for cta in range(begins[p], end))
        seen = {}
        for local in range(counts[p]):
            blocks = fused.cta_blocks(h, w, local)
            assert blocks, (p, local)          # no empty CTA
            for blk in blocks:
                seen[blk] = seen.get(blk, 0) + 1
        assert seen == {(by, bx): 1 for by in range(h // 8)
                        for bx in range(w // 8)}
        groups = -(-(w // 8) // fused.BLOCKS_PER_WARP)
        assert counts[p] == -(-(h // 8) * groups // fused.WARPS_PER_CTA)


def test_picture_layout_of_1080p():
    """1088x1920: 136 block rows of 60 warp tasks, four per CTA; each
    544x960 chroma plane 68 rows of 30."""
    begins, total = fused.picture_layout(PICTURES["1080p"])
    assert begins == (0, 2040, 2550) and total == 3060


#: the kernels that launch one picture on ``csrc/picture_layout.cuh``
LAYOUT_USERS = ("fused_decode.cu", "mc.cu", "recon.cu")


@pytest.mark.parametrize("source", LAYOUT_USERS)
def test_picture_kernels_share_one_layout(source):
    """The fused, MC and reconstruction kernels take the layout from one
    header: each includes it, finds its plane, task and plane descriptors
    through it, and keeps no copy of its constants or its index math."""
    with open(os.path.join(build.CSRC, source)) as f:
        text = f.read()
    assert '#include "picture_layout.cuh"' in text
    for call in ("jsvx::cta_plane(", "jsvx::row_task(",
                 "jsvx::set_plane_layout("):
        assert call in text, call
    for copy in ("constexpr int kWarps", "constexpr int kBlocksPerWarp",
                 "inv_groups", "plane_ctas(", "blockIdx"):
        assert copy not in text, copy


def test_layout_constants_match_the_header():
    """fused.py's layout constants are the header's."""
    with open(os.path.join(build.CSRC, "picture_layout.cuh")) as f:
        text = f.read()
    for name, value in (("kMaxPlanes", fused.MAX_PLANES),
                        ("kWarps", fused.WARPS_PER_CTA),
                        ("kBlocksPerWarp", fused.BLOCKS_PER_WARP)):
        assert f"constexpr int {name} = {value};" in text, name


def test_wrappers_launch_through_one_layout():
    """The MC and reconstruction wrappers lay out their launches with
    fused.py's functions, not a copy of them."""
    from jsvx_torch.kernels import mc, recon

    assert mc.launch_dims is fused.launch_dims
    assert recon.launch_dims is fused.launch_dims


@pytest.mark.parametrize("name", sorted(PICTURES))
def test_launch_dims_follow_the_picture_layout(name):
    """The dims every picture kernel's entry point takes: (h, w,
    is_chroma, first CTA) per plane, the first CTAs and the total from
    :func:`picture_layout`."""
    shapes = PICTURES[name]
    planes = [(h, w, i in (1, 2)) for i, (h, w) in enumerate(shapes)]
    dims, total = fused.launch_dims(planes)
    begins, want_total = fused.picture_layout(shapes)
    assert total == want_total
    assert list(dims) == [v for (h, w, chroma), b in zip(planes, begins)
                          for v in (h, w, int(chroma), b)]


def test_launch_dims_reject_plane_counts():
    for n in (0, 5):
        with pytest.raises(ValueError, match="a picture kernel takes 1 to 4"):
            fused.launch_dims([(16, 16, False)] * n)


def test_wrapper_rejects_other_devices():
    c, ref = _plane_inputs(16, 16, 4)
    tc, tref = _on(c, ref, "meta")
    with pytest.raises(ValueError, match="no fused decode kernel"):
        fused.fused_decode_plane(tc, tref, torch.zeros((), dtype=torch.int32,
                                                       device="meta"),
                                 make_constants(None, "meta"), False)


def test_nvcc_command_targets_hopper_without_fma():
    cmd = build.nvcc_command(["k.cu"], "lib.so")
    assert cmd[cmd.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert "-fmad=false" in cmd
    assert {"-shared", "-O3", "-std=c++17"} <= set(cmd)
    assert cmd[cmd.index("-o") + 1] == "lib.so" and cmd[-1] == "k.cu"
    obj = build.nvcc_command(["k.cu"], "k.o", compile_only=True)
    assert "-c" in obj and "-shared" not in obj
    assert obj[obj.index("-gencode") + 1] == "arch=compute_90a,code=sm_90a"
    assert "-fmad=false" in obj and cmd[-1] == "k.cu"
    assert build.SOURCES == (
        "fused_decode.cu", "recon.cu", "mc.cu", "expand.cu", "color.cu")
    assert all(os.path.exists(os.path.join(build.CSRC, s))
               for s in build.SOURCES)
    assert build.BUILD_ROOT == os.path.join(REPO, "build", "jsvx_torch")


@pytest.mark.parametrize("name", build.SOURCES + ("block_math.cuh",
                                                   "picture_layout.cuh"))
def test_build_key_tracks_every_source_and_header(tmp_path, name):
    """A stale library must never load: an edit to any source or shared
    header changes the build key; other files do not."""
    import shutil

    csrc = tmp_path / "csrc"
    shutil.copytree(build.CSRC, csrc)
    assert sorted(os.listdir(csrc)) == sorted(
        build.SOURCES + ("block_math.cuh", "picture_layout.cuh"))
    key = build._key(str(csrc))
    assert key == build._key(build.CSRC)
    (csrc / "notes.txt").write_text("not compiled")
    assert build._key(str(csrc)) == key
    path = csrc / name
    orig = path.read_bytes()
    path.write_bytes(orig + b"\n// edited\n")
    assert build._key(str(csrc)) != key, name
    path.write_bytes(orig)
    assert build._key(str(csrc)) == key


@pytest.mark.cuda
@pytest.mark.parametrize("source", ["random", *torch_card.GOPS])
def test_kernel_matches_plain_on_the_card(source):
    """One launch a picture, every plane equal to the plain version's:
    random planes and pictures, and every picture of the encoded GOPs of
    ``tests/torch_card.py`` (the quirk where the entry lists it)."""
    dev = torch_card.card()
    if source != "random":
        for i, frame, refs, consts, quirk in torch_card.pictures(source,
                                                                 dev):
            before = fused.launches
            got = fused.decode_frame_planes_fused(frame, refs, consts, quirk)
            want = decode_frame_planes(frame, refs, consts, quirk)
            torch.cuda.synchronize()
            assert fused.launches == before + 1
            for g, w in zip(got, want, strict=True):
                assert torch.equal(g, w), (i, quirk)
        return
    consts = make_constants(None, dev)
    for h, w, chroma, is_p, quirk in CASES + [(1088, 1920, False, 1, False),
                                              (544, 960, True, 1, False)]:
        c, ref = _plane_inputs(h, w, seed=h * w + is_p)
        tc, tref = _on(c, ref, dev)
        ip = torch.tensor(is_p, dtype=torch.int32, device=dev)
        before = fused.launches
        got = fused.fused_decode_plane(tc, tref, ip, consts, chroma, quirk)
        want = decode_frame_plane(tc, tref, ip, consts, chroma, quirk)
        torch.cuda.synchronize()
        assert fused.launches == before + 1
        assert torch.equal(got, want), (h, w, chroma, is_p, quirk)
    # whole pictures: one launch each, every plane equal to the plain one
    for name, shapes in sorted(PICTURES.items()):
        frame = {"is_p": torch.tensor(1, dtype=torch.int32, device=dev)}
        refs = []
        for key, (h, w) in zip(("y", "cb", "cr", "a"), shapes):
            frame[key], ref = _on(*_plane_inputs(h, w, seed=h + w), dev)
            refs.append(ref)
        before = fused.launches
        got = fused.decode_frame_planes_fused(frame, tuple(refs), consts)
        want = decode_frame_planes(frame, tuple(refs), consts)
        torch.cuda.synchronize()
        assert fused.launches == before + 1, name
        for g, w in zip(got, want):
            assert torch.equal(g, w), name


def test_port_never_imports_jax():
    """Importing every module of the port and decoding a clip made by the
    port's encoder on the CPU, through both routes, both wires, the stream
    decoder and the Player (with RGB), loads no JAX (the card's machine
    has none)."""
    code = """
import sys
import numpy as np
import jsvx_torch
import jsvx_torch.__main__
from jsvx_torch.kernels import carry, color, mc, recon
from jsvx_torch.pipeline import gop, packed_parse, stream
from jsvx_torch.api import Player, PlayerConfig
from jsvx_torch.pipeline.transcode import transcode
from jsvx_torch.tools.encoder import EncoderConfig, JsvEncoder
yy, xx = np.mgrid[0:32, 0:48]
frames = [((96 + 40 * np.sin((xx + 2 * t) / 5.0)).astype(np.uint8),
           np.full((16, 24), 120, np.uint8), np.full((16, 24), 130, np.uint8))
          for t in range(4)]
data = JsvEncoder(48, 32, EncoderConfig(gop_size=2)).encode(frames)
res = jsvx_torch.transcode(data, device="cpu")
assert res.n_frames == 4, res
for impl in ("fused", "two_kernel"):
    assert jsvx_torch.transcode(data, device="cpu", impl=impl,
                                quirk_oddify_zeros=True).n_frames == 4
    out = jsvx_torch.StreamDecoder(data, device="cpu").decode(impl=impl)
    assert len(out.frames) == 4
p = Player(PlayerConfig(emit_rgb=True), device="cpu")
shown = []
p.set_frame_sink(lambda rgb, t: shown.append(tuple(rgb.shape)))
p.src = data
p.play()
t = 0.0
while not p.ended and t < 2.0:
    t += 1 / 30.0
    p.tick(t)
assert p.ended and shown == [(32, 48, 3)] * 4, shown
assert "jax" not in sys.modules, "jax was imported"
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
