"""Device-side decoder for :mod:`sykepic_tpu_torch.ingest.wirecodec`
payloads, in plain torch ops (the JAX package's version has no Pallas
kernel, so torch's own elementwise, ``index_add_`` and ``cumsum`` kernels
are the port).

- :func:`unpack_plane`: packed 4-bit plane -> signed int32 deltas.
- :func:`scatter_chunk`: scatter-adds a slice of the exception stream into
  the deltas, carrying the running position between calls. The decoder
  hands it the whole stream at once; the chunking of the format only
  mattered to the JAX decoder's fixed-shape programs.
- :func:`finalize`: cumsum along the per-window predictor axis, mod 256,
  back to uint8 windows.

All arithmetic is int32 with a final ``& 255``; two's-complement AND is an
exact mod-256, so the output is bit-identical to the encoder's input for
any uint8 content (held against
:func:`sykepic_tpu_torch.ingest.wirecodec.decode_reference` in the tests).
"""

from __future__ import annotations

import torch

from ..ingest import wirecodec


def unpack_plane(plane: torch.Tensor) -> torch.Tensor:
    """(Nc, H, W//2) packed nibbles -> (Nc, H, W) int32 signed deltas."""
    p = plane.to(torch.int32)
    nc, h, wh = p.shape
    d = torch.stack([p & 15, p >> 4], dim=-1).reshape(nc, h, wh * 2)
    return d - 16 * (d > 7).to(torch.int32)


def scatter_chunk(d: torch.Tensor, exc: torch.Tensor, carry):
    """Apply a run of exception entries to the deltas, in place.

    ``exc`` is uint8 — advance<<4 | residual>>4 per entry, where a zero low
    nibble marks a dummy whose advance counts 15x. ``carry`` is the last
    decoded position before this run (-1 before the first). Dummy and
    padding entries add 0, and positions outside the tensor (the -1 of an
    all-padding run) are dropped. Returns ``(d, new carry)``; the carry is
    a 0-d tensor, so the call never waits for the device.
    """
    adv = (exc >> 4).to(torch.int64)
    v = (exc & 15).to(torch.int32)
    pos = carry + torch.cumsum(torch.where(v > 0, adv, adv * 15), dim=0)
    flat = d.view(-1)
    keep = (pos >= 0) & (pos < flat.numel())
    flat.index_add_(0, torch.where(keep, pos, 0),
                    torch.where(keep, v << 4, 0))
    return d, pos[-1] if len(pos) else carry


def finalize(d: torch.Tensor, flags: torch.Tensor) -> torch.Tensor:
    """Cumsum mod 256 along each window's predictor axis -> uint8.

    Flag 0 = vertical (cumsum rows), 1 = horizontal (cumsum cols),
    2 = gradient (cumsum rows THEN cols — undoes the second difference).
    int32 is safe un-wrapped: |d| <= 255 per px post-scatter, so the
    chained cumsums stay <= npx * 255 < 2^31 for any packer canvas.
    """
    pv = torch.cumsum(d, dim=1, dtype=torch.int32)
    ph = torch.cumsum(d, dim=2, dtype=torch.int32)
    pg = torch.cumsum(pv, dim=2, dtype=torch.int32)
    f = flags.to(torch.int32)[:, None, None]
    out = torch.where(f == 1, ph, torch.where(f == 2, pg, pv))
    return (out & 255).to(torch.uint8)


def decode(payload: wirecodec.WirePayload, device) -> torch.Tensor:
    """Upload a payload and decode it into uint8 windows on ``device``."""
    def put(a):
        # from pageable memory the copy returns once the source is staged,
        # so the caller may recycle the payload; the host does not wait
        return torch.from_numpy(a).to(device, non_blocking=True)

    return decode_tensors(put(payload.plane), put(payload.exc),
                          put(payload.flags))


def decode_tensors(plane: torch.Tensor, exc: torch.Tensor,
                   flags: torch.Tensor) -> torch.Tensor:
    """A payload's three arrays, already on the device, -> uint8 windows."""
    d = unpack_plane(plane)
    d, _ = scatter_chunk(d, exc, -1)
    return finalize(d, flags)
