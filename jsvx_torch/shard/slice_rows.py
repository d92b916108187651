"""Row-band sharding: one frame's rows across ranks, halo exchange for MC.

The port of ``jsvx/shard/slice_rows.py``.  Dequantisation and IDCT are
block-local, so a row band needs no communication; only P-frame motion
compensation reads up to ``halo`` rows past the band's edges.  Those
boundary strips of the *reconstructed reference planes* are exchanged
once per frame and plane with point-to-point sends over the ``rows`` axis
of a :class:`~jsvx_torch.shard.mesh.Mesh` (jsvx's ``lax.ppermute``); a
Python loop over the frames carries the band's reference planes (jsvx's
``lax.scan``).

The required halo is ``8 * forward_f + 1`` pixels of luma (motion range
is ``+/-(16*forward_f - 1)`` half-pel, jsv.js:850-855).  By default it is
DERIVED from the stream's recorded f_code, and when the derived halo
reaches a band's height — neighbour exchange can no longer cover the
motion range — the reference plane is all-gathered instead and the
band's window cut from it, giving the same bits.

Transport follows the group's backend: NCCL moves the device tensors, gloo
moves host tensors, so under gloo the strips (a few hundred kB per 1080p
plane) are copied to the host, sent, and copied back; the decode stays on
its device.

Every band decodes through the two-kernel route (jsvx's
``mc_impl="pallas"``): the MC kernel (``csrc/mc.cu``) predicts the
halo-extended planes of the picture in one launch, the prediction is cut
to the band's rows, and the reconstruction kernel (``csrc/recon.cu``)
decodes the band in one more launch.  The kernel clamps its taps to the
plane it is given; on the extended plane that is the global clamp,
because the halo rows at a global edge replicate the edge row and,
inside, the halo covers the motion range.  The halo rows' own blocks have
``rep_add`` set, so the kernel stores zeros there and reads no reference
for them.  On the CPU the wrappers run their plain versions.  jsvx's
``"mvset"`` has no counterpart: the port reads per-block vectors and
keeps no distinct-vector table.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
import torch.nn.functional as F

from ..kernels.decode import (DecodeConstants, comp_is_chroma,
                              frame_comp_keys)
from ..kernels.mc import predict_picture_mc
from ..kernels.recon import recon_picture
from ..pipeline.gop import frame_at, gop_at
from .mesh import Mesh

#: the per-block fields of a plane the decode reads (beside ``levels``)
BLOCK_FIELDS = ("lnz", "q", "intra", "mv", "rep_add")


def halo_for_f_code(f_code: int) -> int:
    """Luma halo rows covering f_code's vertical motion range.

    Motion is bounded by ``+/-(16*F - 1)`` half-pel (``F = 1 <<
    (f_code-1)``, jsv.js:850-855) = ``8*F - 1`` full-pel, +1 row for the
    half-pel interpolation tap; rounded up to a multiple of 16 so the
    chroma halo (half) stays a multiple of the 8-pixel block grid.
    """
    full = 8 * (1 << (max(int(f_code), 1) - 1)) + 1
    return -(-full // 16) * 16


def derive_halo_y(stacked: dict) -> int:
    """Halo from the stacked frames' recorded ``f_code`` (a numpy array
    or a tensor; read once, on the host, before any decode)."""
    fc = stacked.get("f_code")
    if fc is None:
        return 16                          # no P pictures recorded
    mx = (int(fc.max().item()) if isinstance(fc, torch.Tensor)
          else int(np.asarray(fc).max()))
    if mx <= 0:
        return 16
    return halo_for_f_code(mx)


def check_route(impl: str, halo_y: int) -> None:
    """Raise unless ``impl`` is the band route, ``"two_kernel"``, and
    ``halo_y`` a multiple of 16, so that the chroma extended plane stays a
    whole number of 8-row blocks."""
    if impl != "two_kernel":
        raise ValueError(f"impl must be 'two_kernel', the port's one band "
                         f"route, got {impl!r}")
    if halo_y % 16:
        raise ValueError(f"impl='two_kernel' needs halo_y a multiple of 16, "
                         f"got {halo_y}")


def band_rows(h: int, n: int) -> int:
    """Rows of each of ``n`` bands of an ``h``-row plane; raises unless
    they are whole 8-row block rows."""
    if h % n or (h // n) % 8:
        raise ValueError(f"a plane of {h} rows does not split into {n} "
                         f"bands of whole 8-row blocks")
    return h // n


def _tensor(a, device) -> torch.Tensor:
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a))
    return t.to(device).contiguous()


def cut_band(stacked: dict, idx: int, n: int, device) -> dict:
    """Band ``idx`` of ``n`` of a stacked GOP (numpy or tensors, leading
    frame axis), on ``device``: the ``h // n`` rows of every plane from
    row ``idx * h // n``, and the per-block grids cut at the same block
    rows.  Fields the port's decode does not read are dropped."""
    out = {"is_p": _tensor(stacked["is_p"], device)}
    for key in frame_comp_keys(stacked):
        c = stacked[key]
        rows = band_rows(c["levels"].shape[-2], n)
        r0 = idx * rows
        out[key] = {"levels": _tensor(c["levels"][:, r0:r0 + rows], device)}
        for f in BLOCK_FIELDS:
            out[key][f] = _tensor(c[f][:, r0 // 8:(r0 + rows) // 8], device)
    return out


def stack_gops(runs: list) -> tuple:
    """GOP decodes' ((planes per plane), (final planes)) -> the two
    tuples stacked on a leading GOP axis."""
    return tuple(tuple(torch.stack([r[part][c] for r in runs])
                       for c in range(len(runs[0][part])))
                 for part in (0, 1))


# ---------------------------------------------------------------------------
# The halo: exchange with the neighbours, or all-gather and cut a window


def _host_staged(group) -> bool:
    """Whether ``group``'s backend moves host tensors (gloo) rather than
    device tensors (NCCL)."""
    backend = dist.get_backend(group)
    if backend == dist.Backend.GLOO:
        return True
    if backend == dist.Backend.NCCL:
        return False
    raise ValueError(f"no row transport over backend {backend!r}")


def edge_window(full: torch.Tensor, row0: int, rows: int,
                halo: int) -> torch.Tensor:
    """Rows ``[row0 - halo, row0 + rows + halo)`` of ``full`` edge-padded
    by ``halo`` rows (rows above or below the plane replicate its edge
    row): a band's extended plane, as a fresh contiguous tensor."""
    h = full.shape[0]
    lo, hi = row0 - halo, row0 + rows + halo
    return torch.cat([full[:1].expand(max(0, -lo), -1),
                      full[max(lo, 0):min(hi, h)],
                      full[-1:].expand(max(0, hi - h), -1)])


def gather_rows(planes: torch.Tensor, mesh: Mesh,
                axis: str = "rows") -> torch.Tensor:
    """All-gather the bands of ``axis`` into whole planes: ``planes`` is
    this rank's band, its rows on dimension -2 ((h, w) or (frames, h,
    w)); every rank of the axis gets the whole, on the band's device."""
    group = mesh.group(axis)
    if group is None:                      # a mesh of size 1: no peers
        return planes
    wire = planes.cpu() if _host_staged(group) else planes.contiguous()
    parts = [torch.empty_like(wire) for _ in range(mesh.axis_size(axis))]
    dist.all_gather(parts, wire, group=group)
    return torch.cat(parts, dim=-2).to(planes.device)


def gather_row_halo(local: torch.Tensor, halo: int, mesh: Mesh,
                    axis: str = "rows") -> torch.Tensor:
    """All-gather fallback: ``halo`` >= the band's height, so neighbour
    sends cannot cover the motion range.  Gathers the whole plane,
    edge-pads it and cuts this band's ``(h_local + 2*halo)``-row window —
    downstream code is the same as after the exchange."""
    h_local = local.shape[0]
    full = gather_rows(local, mesh, axis)
    return edge_window(full, mesh.index(axis) * h_local, h_local, halo)


def exchange_row_halo(local: torch.Tensor, halo: int, mesh: Mesh,
                      axis: str = "rows") -> torch.Tensor:
    """Extend a band with ``halo`` rows from each neighbour.

    Ranks at the global edges replicate their own boundary row into the
    halo, so the extended band reproduces CLAMP_TO_EDGE locally.  The
    interior strips move in one ``batch_isend_irecv``, both directions at
    once, so no rank waits on another's send.  ``halo`` may not exceed
    the band's height (use :func:`gather_row_halo`).
    """
    h_local, w = local.shape
    if halo > h_local:
        raise ValueError(f"halo {halo} exceeds the band's {h_local} rows")
    if halo == 0:
        return local
    n, idx = mesh.axis_size(axis), mesh.index(axis)
    top = local[:1].expand(halo, w)
    bot = local[-1:].expand(halo, w)
    if n > 1:
        group = mesh.group(axis)
        at = torch.device("cpu") if _host_staged(group) else local.device
        ops, recv = [], {}
        # rows just above my band are the bottom strip of rank idx-1, rows
        # just below it the top strip of rank idx+1
        for side, nb, strip in (("top", idx - 1, local[:halo]),
                                ("bot", idx + 1, local[-halo:])):
            if not 0 <= nb < n:
                continue
            peer = mesh.peer(axis, nb)
            recv[side] = torch.empty((halo, w), dtype=local.dtype, device=at)
            ops += [dist.P2POp(dist.isend, strip.to(at), peer, group),
                    dist.P2POp(dist.irecv, recv[side], peer, group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        top = recv["top"].to(local.device) if "top" in recv else top
        bot = recv["bot"].to(local.device) if "bot" in recv else bot
    return torch.cat([top, local, bot])


def extend_band(local: torch.Tensor, halo: int, mesh: Mesh,
                axis: str = "rows") -> torch.Tensor:
    """A band's plane extended by ``halo`` rows each side: by the
    neighbour exchange while the halo is below the band's height, else
    by the all-gather (the same rows)."""
    if halo < local.shape[0]:
        return exchange_row_halo(local, halo, mesh, axis)
    return gather_row_halo(local, halo, mesh, axis)


# ---------------------------------------------------------------------------
# One band of one picture, and the GOP loops


def plane_halos(frame: dict, halo_y: int) -> list:
    """The halo of each plane of a picture: ``halo_y`` for luma and
    alpha, half of it for chroma."""
    return [halo_y // 2 if comp_is_chroma(i) else halo_y
            for i in range(len(frame_comp_keys(frame)))]


def halo_sideband(frame: dict, halo_y: int) -> dict:
    """The MC kernel's per-block inputs for a band's extended planes:
    each plane's ``mv`` and ``rep_add`` with ``halo / 8`` block rows added
    on each side, ``rep_add`` set there (the kernel stores zeros and reads
    no reference for them; nothing reads those rows)."""
    ext = {}
    for key, halo in zip(frame_comp_keys(frame), plane_halos(frame, halo_y)):
        hb = halo // 8
        ext[key] = {"mv": F.pad(frame[key]["mv"], (0, 0, 0, 0, hb, hb)),
                    "rep_add": F.pad(frame[key]["rep_add"], (0, 0, hb, hb),
                                     value=1)}
    return ext


def decode_band_picture(frame: dict, ext_refs: tuple, halo_y: int,
                        consts: DecodeConstants,
                        quirk_oddify_zeros: bool = False,
                        outs: tuple | None = None) -> tuple:
    """A band of every plane of one picture -> uint8 planes (``outs`` if
    given).

    ``frame`` holds the band's rows and block rows (:func:`cut_band`);
    ``ext_refs`` the band's reference planes extended by the halo (luma
    ``halo_y`` rows on each side, chroma ``halo_y // 2``).  One MC launch
    over the extended planes (:func:`halo_sideband`), then one
    reconstruction launch on the band with the prediction's band rows.
    """
    check_route("two_kernel", halo_y)
    halos = plane_halos(frame, halo_y)
    preds = predict_picture_mc(halo_sideband(frame, halo_y), ext_refs)
    preds = tuple(p[halo:p.shape[0] - halo] for p, halo in zip(preds, halos))
    return recon_picture(frame, preds, frame["is_p"], consts,
                         quirk_oddify_zeros, outs)


def _decode_frame_local(frame: dict, refs: tuple, consts: DecodeConstants,
                        halo_y: int, mesh: Mesh, axis: str, quirk: bool,
                        outs: tuple) -> tuple:
    """One picture of this rank's band: extend each reference plane
    (:func:`extend_band`), then decode the band."""
    ext = tuple(extend_band(ref, halo, mesh, axis)
                for ref, halo in zip(refs, plane_halos(frame, halo_y)))
    return decode_band_picture(frame, ext, halo_y, consts, quirk, outs)


def decode_gop_rows_sharded(stacked: dict, init_refs: tuple,
                            consts: DecodeConstants, mesh: Mesh,
                            axis: str = "rows", halo_y: int | None = None,
                            quirk_oddify_zeros: bool = False,
                            impl: str = "two_kernel",
                            device="cuda") -> tuple:
    """Decode a stacked GOP with every plane row-banded over ``axis``.

    Every rank of the axis passes the whole GOP (``stacked``: per-frame
    stacks on a leading axis, numpy or tensors) and the whole initial
    reference planes ``init_refs``; it keeps its own band (:func:`cut_band`)
    on ``device`` and decodes it frame by frame, the band's reference
    planes carried from frame to frame, one halo exchange (or all-gather)
    per frame and plane.  Returns (this rank's band stacks (Y, Cb, Cr[,
    A]), the final band reference planes); :func:`gather_rows` assembles
    the whole planes.

    ``halo_y=None`` (the default) derives the halo from the GOP's recorded
    f_code (:func:`derive_halo_y`).  ``impl`` names jsvx's
    ``mc_impl``; the port has one band route, ``"two_kernel"``
    (:func:`decode_band_picture`), and raises on any other.
    """
    if halo_y is None:
        halo_y = derive_halo_y(stacked)
    check_route(impl, halo_y)
    device = torch.device(device)
    n, idx = mesh.axis_size(axis), mesh.index(axis)
    band = cut_band(stacked, idx, n, device)
    refs = []
    for r in init_refs[:len(frame_comp_keys(stacked))]:
        rows = band_rows(r.shape[0], n)
        refs.append(_tensor(r[idx * rows:(idx + 1) * rows], device))
    n_frames = band["is_p"].shape[0]
    outs = tuple(torch.empty((n_frames,) + tuple(r.shape), dtype=torch.uint8,
                             device=device) for r in refs)
    refs = tuple(refs)
    for i in range(n_frames):
        refs = _decode_frame_local(frame_at(band, i), refs, consts, halo_y,
                                   mesh, axis, quirk_oddify_zeros,
                                   tuple(o[i] for o in outs))
    return outs, refs


def decode_gops_2d_sharded(batch: dict, init_refs: tuple,
                           consts: DecodeConstants, mesh: Mesh,
                           gop_axis: str = "gop", rows_axis: str = "rows",
                           halo_y: int | None = None,
                           quirk_oddify_zeros: bool = False,
                           impl: str = "two_kernel",
                           device="cuda") -> tuple:
    """The two-axis step: a batch of GOPs split over ``gop_axis`` (DP),
    each GOP's rows over ``rows_axis`` (SP) with the per-frame halo
    exchange.

    ``batch`` leaves lead with ``(n_gops, n_frames, ...)``, ``init_refs``
    planes with ``n_gops``; ``n_gops`` must divide by the GOP axis's size.
    This rank decodes the GOPs of its GOP coordinate one after the other
    (jsvx vmaps them) through :func:`decode_gop_rows_sharded`.  Returns
    (band stacks (GOPs, frames, h_local, w) per plane, final band refs
    (GOPs, h_local, w) per plane, the GOPs' indices in the batch).
    """
    if halo_y is None:
        halo_y = derive_halo_y(batch)
    gops = mesh.shard_range(batch["is_p"].shape[0], gop_axis)
    return (*stack_gops([decode_gop_rows_sharded(
        gop_at(batch, g), tuple(r[g] for r in init_refs), consts, mesh,
        rows_axis, halo_y, quirk_oddify_zeros, impl, device) for g in gops]),
        gops)
