"""The check fails its control and the planted faults.

The control is the reference in the program's place with its IDCT (and
colour) in TF32, at ``vcd-sif``'s own size (``jsvbench/control.py`` runs
it at every cell's size).  The faults are planted under a run of the
tiny cells on the CPU (the look for a card skipped): a P picture that
returns its reference unchanged, half of each GOP's pictures left out,
a picture altered where it is produced, and each GOP handed the planes of
the GOP before it (a replay skipped, an output left as it was).  One card, so there is no
exchange between chips to leave out."""

import pytest
import torch

from jsvbench.control import control_numbers
from jsvbench.tests.helpers import run_tiny, tiny_copy
from jsvx_torch.api import player
from jsvx_torch.pipeline import program


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_control_is_not_correct(seed, tmp_path):
    got = control_numbers("vcd-sif.transcode", seed,
                          cache_dir=str(tmp_path))
    assert not got["correct"], got


def unchanged(outs):
    return tuple(torch.cat([o[:1]] * len(o)) for o in outs)


def half(outs):
    """The second half of each GOP's pictures never decoded (left 0)."""
    outs = tuple(o.clone() for o in outs)
    for o in outs:
        o[(len(o) + 1) // 2:] = 0
    return outs


def altered(outs):
    outs = tuple(o.clone() for o in outs)
    outs[0][len(outs[0]) // 2] += 1
    return outs


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    return tiny_copy(str(tmp_path_factory.mktemp("faults")))


@pytest.mark.parametrize("cell", ["tiny.transcode", "tiny.play"])
@pytest.mark.parametrize("fault", [unchanged, half, altered])
def test_faults_are_not_correct(tiny, cell, fault, monkeypatch):
    assert run_tiny(*tiny, cell)["correct"]
    run = program.GopProgram.run

    def broken(self, copied, metrics):
        outs, event = run(self, copied, metrics)
        return fault(outs), event

    monkeypatch.setattr(program.GopProgram, "run", broken)
    assert not run_tiny(*tiny, cell)["correct"]


def test_altered_colour_is_not_correct(tiny, monkeypatch):
    rgb = player.ycbcr_to_rgb

    def broken(*a, **k):
        out = rgb(*a, **k).clone()
        out[::7, ::5, 1] ^= 4
        return out

    monkeypatch.setattr(player, "ycbcr_to_rgb", broken)
    assert not run_tiny(*tiny, "tiny.play")["correct"]


@pytest.mark.parametrize("cell", ["tiny.transcode", "tiny.play"])
def test_previous_gops_planes_are_not_correct(tiny, cell, monkeypatch):
    run = program.GopProgram.run
    last = []

    def stale(self, copied, metrics):
        outs, event = run(self, copied, metrics)
        got = last[0] if last and [o.shape for o in last[0]] == [
            o.shape for o in outs] else outs
        last[:] = [outs]
        return got, event

    monkeypatch.setattr(program.GopProgram, "run", stale)
    assert not run_tiny(*tiny, cell)["correct"]
