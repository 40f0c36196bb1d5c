"""Plain training steps: the augmentation draws, the augmented resize, the
network in training mode, the weighted cross-entropy, its gradients and an
Adam update with three learning-rate groups.

- Draws: per batch part (one canvas bucket of a mixed batch), from one
  ``torch.Generator`` in this order: horizontal and vertical flips (a
  uniform draw below 0.5 each), translations (integers uniform in ``[-lim,
  lim]`` from ``floor(u (2 lim + 1))``), the zoom factor (uniform in the
  range, rounded to two decimals half to even) and the brightness factor
  (uniform in the range). Translation limits: ``int((target - new) / 2.5)``
  on the padded axis of the ROI as shipped, 0 on the other.
- Each axis samples output index ``i`` at ``a i + b``: ``a = 1 / f``, ``b =
  c (1 - 1 / f) - t`` with ``c = (target - 1) / 2``, and ``a = -a``, ``b =
  target - 1 - b`` where flipped (float32, in this order).
- Loss: ``sum(w * ce) / max(sum(w), 1)`` over the batch (weights 0 for the
  wrapped rows of a plan); BatchNorm takes the batch's statistics.
- Adam as optax's ``scale_by_adam``: ``b1 = 0.9``, ``b2 = 0.999``, ``eps =
  1e-8`` outside the root, bias corrections ``1 - b**t`` in float32; the
  update of group ``g`` is scaled by ``-lr[g]``. Groups: the head and every
  BatchNorm 0, the last backbone stage 1, the rest 2.
"""

from __future__ import annotations

import numpy as np
import torch
from torch.nn import functional as F

from .layers import tf32
from .preprocess import as_shipped, preprocess, resize_geometry

B1, B2, EPS = 0.9, 0.999, 1e-8


def limits(images, target: int) -> tuple[np.ndarray, np.ndarray]:
    """Translation limits ``(x, y)`` of ROIs, as shipped."""
    lx, ly = [], []
    for im in images:
        h, w = as_shipped(np.asarray(im), target).shape
        nh, nw = resize_geometry(h, w, target)
        taller = h > w
        lx.append(int((target - nw) / 2.5) if taller else 0)
        ly.append(0 if taller else int((target - nh) / 2.5))
    return np.array(lx, np.int64), np.array(ly, np.int64)


def _uniform(gen, n, lo, hi, device):
    u = torch.rand(n, generator=gen, device=device)
    return torch.clamp(u * (hi - lo) + lo, min=lo)


def _randint(gen, lim, device):
    span = (2 * lim + 1).to(torch.float32)
    u = torch.rand(lim.shape, generator=gen, device=device)
    return torch.minimum(torch.floor(u * span), span - 1.0) - lim.float()


def draw(gen, n: int, lim_x, lim_y, aug: dict, device) -> dict:
    """One part's draws: ``flip_h, flip_v`` (bool), ``tx, ty, f, bright``
    (float32), each ``(n,)``."""
    d = {"flip_h": torch.zeros(n, dtype=torch.bool, device=device),
         "tx": torch.zeros(n, device=device), "f": torch.ones(n, device=device),
         "bright": torch.ones(n, device=device)}
    d["flip_v"], d["ty"] = d["flip_h"], d["tx"]
    if aug.get("flip"):
        d["flip_h"] = torch.rand(n, generator=gen, device=device) < 0.5
        d["flip_v"] = torch.rand(n, generator=gen, device=device) < 0.5
    if aug.get("translate"):
        d["tx"] = _randint(gen, torch.as_tensor(lim_x, device=device), device)
        d["ty"] = _randint(gen, torch.as_tensor(lim_y, device=device), device)
    if aug.get("zoom"):
        f = _uniform(gen, n, *aug["zoom_range"], device)
        d["f"] = torch.round(f * 100.0) / torch.full_like(f, 100.0)
    if aug.get("brightness"):
        d["bright"] = _uniform(gen, n, *aug["brightness_range"], device)
    return d


def affine(d: dict, target: int) -> torch.Tensor:
    """``(4, n)`` float32 rows ``a_y, b_y, a_x, b_x``."""
    inv = torch.ones_like(d["f"]) / d["f"]
    c = (target - 1) / 2.0
    rows = []
    for flipped, t in ((d["flip_v"], d["ty"]), (d["flip_h"], d["tx"])):
        a, b = inv, c * (1.0 - inv) - t
        rows += [torch.where(flipped, -a, a),
                 torch.where(flipped, (target - 1) - b, b)]
    return torch.stack(rows)


def group(name: str, kind: str, net) -> int:
    if name.startswith("head.") or kind in ("bn_weight", "bn_bias"):
        return 0
    return 1 if net.top_stage(name) else 2


class Steps:
    """Training from ``params`` (copied): :meth:`step` runs one batch.
    ``quant="fp8"`` computes every convolution and product in float8 (the
    control)."""

    def __init__(self, params: dict, net, cfg: dict, aug: dict, lrs, seed,
                 device, quant=None):
        specs = net.param_specs(cfg)
        self.names = [n for n, _, kind, _ in specs
                      if kind not in ("bn_mean", "bn_var", "bn_count")]
        kinds = {n: kind for n, _, kind, _ in specs}
        self.params = {n: params[n].detach().clone().float()
                       for n in self.names}
        self.lr = [float(lrs[group(n, kinds[n], net)]) for n in self.names]
        self.mu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.nu = {n: torch.zeros_like(p) for n, p in self.params.items()}
        self.count = 0
        self.gen = torch.Generator(device=device).manual_seed(seed)
        self.net, self.cfg, self.aug = net, cfg, aug
        self.device, self.quant = device, quant

    def step(self, parts, weights: np.ndarray):
        """One batch: ``parts`` lists ``(images, labels)`` per bucket in
        batch order; ``weights`` the whole batch's. Returns ``(loss,
        grads)``, ``grads`` by name, as the optimizer gets them."""
        _, size, _ = self.cfg["image_shape"]
        chans = self.cfg["image_shape"][0]
        xs, ys = [], []
        for images, labels in parts:
            lx, ly = limits(images, size)
            d = draw(self.gen, len(images), lx, ly, self.aug, self.device)
            xs.append(preprocess(images, size, chans, self.device,
                                 affine(d, size), d["bright"]))
            ys.append(torch.as_tensor(np.asarray(labels), device=self.device))
        x, y = torch.cat(xs), torch.cat(ys).long()
        w = torch.as_tensor(weights, dtype=torch.float32, device=self.device)
        leaves = {n: p.requires_grad_(True) for n, p in self.params.items()}
        p = {**leaves, "bn": "train", "quant": self.quant}
        with tf32(False):
            logits = self.net.forward(p, x, self.cfg).float()
            losses = F.cross_entropy(logits, y, reduction="none")
            loss = (losses * w).sum() / torch.clamp(w.sum(), min=1.0)
            grads = torch.autograd.grad(loss, list(leaves.values()))
        grads = dict(zip(leaves, grads))
        self.count += 1
        bc1 = float(np.float32(1) - np.float32(B1) ** np.float32(self.count))
        bc2 = float(np.float32(1) - np.float32(B2) ** np.float32(self.count))
        with torch.no_grad():
            for (n, param), lr in zip(self.params.items(), self.lr):
                g = grads[n]
                self.mu[n].mul_(B1).add_(g, alpha=1.0 - B1)
                self.nu[n].mul_(B2).add_(g * g, alpha=1.0 - B2)
                upd = (self.mu[n] / bc1) / (torch.sqrt(self.nu[n] / bc2)
                                            + EPS)
                param.requires_grad_(False)
                param.add_(upd, alpha=-lr)
        return float(loss.detach()), grads
