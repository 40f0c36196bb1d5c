"""Training machinery: staged fine-tuning with 3-group learning rates (the
port of ``sykepic_tpu/train/trainer.py``).

Reference semantics being reproduced (``sykepic/train/network.py:75-187``,
``train.py:122-163``), as the JAX package keeps them:

- ``freeze(net.base)``: at start only the head trains, *except* BatchNorm
  affine params which stay trainable everywhere; they ride in LR group 0
  with the head.
- ``LRWarmup`` stages: at ``step_2`` the last base stage (layer4) unfreezes
  into group 1; at ``step_3`` the rest of the base into group 2
  (:class:`LRSchedule`).
- ``ReduceLROnPlateau`` on val loss after warmup.

The epoch-varying state is a 3-vector of learning rates and a ``stage`` in
{0, 1, 2}. Frozen groups' gradients are zero tensors (their parameters do
not ask autograd for one), so one optimizer state with one step count runs
over every parameter, as the JAX package's single optax transform does:
frozen moments stay exactly zero until their group opens.

A train step: K1's train form per canvas bucket writes the augmented,
normalised NHWC batch straight from the device-resident store
(:mod:`sykepic_tpu_torch.ops.resize_pad`); the network runs on its
channels_last NCHW view under autocast (``[train] dtype = bfloat16``;
parameters and optimizer state stay float32); the loss is the float32
softmax cross-entropy on the logits, weighted; the backward pass is
cuDNN/cuBLAS through autograd (the JAX step had no Pallas kernel there);
the update is the optax transform written out (:func:`make_optimizer`).
Augmentation draws and dropout masks come from the trainer's own
``torch.Generator``, in batch order, so a seeded run repeats and the
per-step loop equals the whole-epoch call.
"""

from __future__ import annotations

import re

import numpy as np
import torch
from torch.nn import functional as F

from .. import device as device_mod
from ..models import checkpoint
from ..models.resnet import Dropout, StochasticDepth
from ..ops import augment as augment_ops
from ..ops import preprocess, resize_pad

G_HEAD, G_TOP, G_REST = 0, 1, 2  # LR groups: head+BN / layer4 / rest of base

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def label_params(params):
    """Group-id tree matching a Flax-named ``params`` tree (the JAX
    package's function, ``sykepic_tpu/train/trainer.py:59-92``): head + all
    BatchNorm -> group 0, the LAST backbone stage (``layer4*`` of ResNet,
    RegNet and ConvNeXt, ``layer5*`` of VGG, ``layer3*`` of AlexNet, the
    last block + ``head_conv`` of EfficientNet and MobileNetV3) -> group
    1, rest -> group 2. ConvNeXt's LayerNorms are not BatchNorm: they go
    with their stage. :func:`param_groups` carries it to the port's
    names."""
    flat = checkpoint._flatten(params)
    # highest layer-group index present = the "last sequential part"
    top = 0
    for path in flat:
        name = str(path[0])
        if name.startswith("layer"):
            try:
                top = max(top, int(name[5:].split("_")[0]))
            except ValueError:
                pass
    labels = {}
    for path in flat:
        parts = [str(p) for p in path]
        # BatchNorm module names across families: "bn1" (resnet),
        # "stem_bn"/"project_bn" (efficientnet/mobilenet),
        # "layer5_bn2" (vgg_bn)
        is_bn = any(
            re.search(r"(^|_)bn\d*$", p) for p in parts[:-1]
        )
        if parts[0] == "head":
            g = G_HEAD
        elif is_bn:
            g = G_HEAD
        elif parts[0].startswith(f"layer{top}") or parts[0] == "head_conv":
            g = G_TOP
        else:
            g = G_REST
        labels[path] = g
    return checkpoint._unflatten(labels)


def param_groups(model) -> dict:
    """LR group of every parameter of ``model`` by its torch name:
    :func:`label_params` on the model's Flax-named tree, carried across
    with the key map of :func:`~sykepic_tpu_torch.models.checkpoint.
    flax_paths`."""
    paths = checkpoint.flax_paths(model.state_dict(),
                                  getattr(model, "network", None))
    labels = label_params(checkpoint._unflatten(
        {p[1:]: None for p in paths.values() if p[0] == "params"}))
    out = {}
    for name, _ in model.named_parameters():
        node = labels
        for k in paths[name][1:]:
            node = node[k]
        out[name] = node
    return out


class Optimizer:
    """An optax gradient transform over lists of tensors: ``update`` turns
    gradients into the direction that the step scales by ``-lr``
    (``sykepic_tpu/train/trainer.py:95-109``):

    - ``adam``: ``scale_by_adam()`` (b1 0.9, b2 0.999, eps 1e-8, bias
      correction by one shared step count);
    - ``adamw``: that, then ``add_decayed_weights(1e-2)`` (decay after the
      Adam direction and before ``-lr``, where ``torch.optim.AdamW`` decays
      first);
    - ``sgd``: the gradient itself;
    - ``rmsprop``: ``scale_by_rms(decay=0.99, eps=1e-8)``, i.e.
      ``g / sqrt(nu + eps)`` with eps inside the root, where
      ``torch.optim.RMSprop`` takes ``g / (sqrt(nu) + eps)``.
    """

    B1, B2, EPS = 0.9, 0.999, 1e-8
    RMS_DECAY = 0.99
    WEIGHT_DECAY = 1e-2

    def __init__(self, name: str):
        self.name = name.lower()
        if self.name not in ("adam", "adamw", "sgd", "rmsprop"):
            raise ValueError(f"Unsupported optimizer: {name}")

    def init(self, params) -> dict:
        state: dict = {"count": 0}
        if self.name in ("adam", "adamw"):
            state["mu"] = [torch.zeros_like(p) for p in params]
        if self.name != "sgd":
            state["nu"] = [torch.zeros_like(p) for p in params]
        return state

    @staticmethod
    def _bias_correction(decay: float, count: int) -> float:
        # optax: 1 - decay**count in float32
        return float(np.float32(1.0) - np.float32(decay) ** np.float32(count))

    def update(self, grads, state: dict, params) -> list:
        state["count"] += 1
        if self.name == "sgd":
            return list(grads)
        if self.name == "rmsprop":
            d = self.RMS_DECAY
            nu = state["nu"]
            torch._foreach_mul_(nu, d)
            torch._foreach_add_(nu, torch._foreach_mul(grads, grads),
                                alpha=1.0 - d)
            return torch._foreach_mul(
                grads, torch._foreach_rsqrt(torch._foreach_add(nu, self.EPS)))
        mu, nu = state["mu"], state["nu"]
        torch._foreach_mul_(mu, self.B1)
        torch._foreach_add_(mu, grads, alpha=1.0 - self.B1)
        torch._foreach_mul_(nu, self.B2)
        torch._foreach_add_(nu, torch._foreach_mul(grads, grads),
                            alpha=1.0 - self.B2)
        mu_hat = torch._foreach_div(
            mu, self._bias_correction(self.B1, state["count"]))
        nu_hat = torch._foreach_div(
            nu, self._bias_correction(self.B2, state["count"]))
        denom = torch._foreach_add(torch._foreach_sqrt(nu_hat), self.EPS)
        updates = torch._foreach_div(mu_hat, denom)
        if self.name == "adamw":
            torch._foreach_add_(updates, list(params),
                                alpha=self.WEIGHT_DECAY)
        return updates


def make_optimizer(name: str) -> Optimizer:
    """Gradient-direction transform for a torch ``optim`` name
    (reference ``train.py:132``: ``getattr(optim, name)``)."""
    return Optimizer(name)


class Trainer:
    """Owns the model, the optimizer state and the train/eval steps.

    ``model`` is a model of :mod:`sykepic_tpu_torch.models.registry`
    holding its weights; it moves to ``device`` (``cuda`` unless ``cpu`` is
    asked for; ``cuda`` without a card raises) in channels_last. ``dtype``
    is the compute dtype ("float32" or "bfloat16").
    """

    def __init__(self, model, optimizer: str = "Adam", preprocess_spec=None,
                 augment_kwargs: dict | None = None, seed: int = 0,
                 device=None, dtype: str = "float32"):
        self.device = device_mod.resolve(device)
        if dtype not in _DTYPES:
            raise ValueError(f"dtype must be one of {sorted(_DTYPES)}")
        self.dtype = _DTYPES[dtype]
        self.augment_kwargs = dict(augment_kwargs or {})
        if self.device.type == "cuda" and self.dtype == torch.float32:
            # cuDNN convolutions default to TF32 (about three digits)
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        self.model = model.to(self.device, memory_format=torch.channels_last)
        self.spec = preprocess_spec
        self.gen = torch.Generator(device=self.device).manual_seed(seed)
        for m in self.model.modules():
            if isinstance(m, (Dropout, StochasticDepth)):
                m.generator = self.gen
        groups = param_groups(self.model)
        self.names = [n for n, _ in self.model.named_parameters()]
        self.params = [p for _, p in self.model.named_parameters()]
        self.labels = [groups[n] for n in self.names]
        self.tx = make_optimizer(optimizer)
        self.opt_state = self.tx.init(self.params)
        self.mean = self.std = None
        if preprocess_spec is not None and preprocess_spec.imagenet_normalization:
            c = preprocess_spec.num_chans
            self.mean = torch.tensor(preprocess.IMAGENET_MEAN[:c],
                                     dtype=torch.float32, device=self.device)
            self.std = torch.tensor(preprocess.IMAGENET_STD[:c],
                                    dtype=torch.float32, device=self.device)

    # ---------------------------------------------------------- preprocessing
    def _put(self, a, dtype=None) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(a))
        if dtype is not None:
            t = t.to(dtype)
        return t.to(self.device, non_blocking=True)

    def _preprocess(self, parts, train: bool):
        """K1 over ``parts``, a list of ``(store, idx)`` (``idx`` a device
        int64 row vector), one launch per part into one NHWC batch; returns
        ``(x, y)``. Train steps take K1's train form: the augmentation
        affines and brightness (when ``augment_kwargs`` is set; brightness
        alone off still floors, as the JAX step's ``apply_brightness`` with
        factors of 1 does) and the ImageNet normalisation (when the spec
        asks). With ``rotate`` on, the JAX step's other route: K1's eval
        form on the 0-255 scale, then :func:`~sykepic_tpu_torch.ops.augment.
        augment_batch` (the whole affine chain as one warp, brightness and
        floor), ``/ 255``, the channel copy and the normalisation. Eval
        never normalises (the reference normalises only its train
        transform)."""
        spec = self.spec
        t_h, t_w, c = spec.target_h, spec.target_w, spec.num_chans
        total = sum(int(idx.numel()) for _, idx in parts)
        x = torch.empty((total, t_h, t_w, c), dtype=self.dtype,
                        device=self.device)
        ys = []
        kw = self.augment_kwargs if train else {}
        norm = train and self.mean is not None
        mean = self.mean if norm else None
        std = self.std if norm else None
        pos = 0
        for store, idx in parts:
            n = int(idx.numel())
            meta = store["meta"].index_select(1, idx)
            out = x[pos:pos + n]
            draws = None
            if kw:
                lim = store["lim"].index_select(1, idx)
                draws = augment_ops.draw_params(
                    self.gen, n, lim[0], lim[1], device=self.device,
                    flip=kw.get("flip", False),
                    translate=kw.get("translate", False),
                    zoom=kw.get("zoom", False),
                    brightness=kw.get("brightness", False),
                    rotate=kw.get("rotate", False),
                    zoom_range=kw.get("zoom_range", (1.0, 1.0)),
                    brightness_range=kw.get("brightness_range", (1.0, 1.0)),
                    max_rotation=kw.get("max_rotation", 0))
            if kw.get("rotate"):
                img = resize_pad.resize_pad(store["canvas"], meta, t_h, t_w,
                                            1, torch.float32, raw=True)
                img = augment_ops.augment_batch(img[..., 0], draws, meta[9])
                out.copy_(preprocess.to_channels(img, c, self.dtype, mean,
                                                 std))
            else:
                resize_pad.resize_pad(
                    store["canvas"], meta, t_h, t_w, c, self.dtype,
                    affine=(None if draws is None
                            else augment_ops.affine_rows(draws, t_h, t_w)),
                    bright=None if draws is None else draws.bright.contiguous(),
                    mean=mean, std=std, out=out)
            ys.append(store["labels"].index_select(0, idx))
            pos += n
        return x, torch.cat(ys)

    def _host_store(self, batch):
        """A HostBatch as a one-off device store read at rows 0..B-1."""
        from .device_data import device_store, make_store

        store = device_store(make_store(batch.canvas, batch.heights,
                                        batch.widths, batch.labels,
                                        self.spec), self.device)
        idx = torch.arange(len(batch.canvas), device=self.device)
        return store, idx

    # ---------------------------------------------------------------- steps
    def _core_update(self, x, y, wts, stage: int, lrs):
        """Forward, weighted loss, backward, stage mask and update on a
        preprocessed NHWC batch ``x``; returns device ``(loss_sum,
        correct, n)``. Parameters of groups above ``stage`` ask autograd for
        no gradient and get a zero tensor, so their moments stay zero and
        the one step count advances for all."""
        self.model.train()
        opened = [lab <= stage for lab in self.labels]
        for p, o in zip(self.params, opened):
            p.requires_grad_(o)
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            logits = self.model(x.permute(0, 3, 1, 2))
        logits = logits.float()
        losses = F.cross_entropy(logits, y, reduction="none")
        n = wts.sum()
        loss = (losses * wts).sum() / torch.clamp(n, min=1.0)
        live = [p for p, o in zip(self.params, opened) if o]
        got = iter(torch.autograd.grad(loss, live))
        grads = [next(got) if o else torch.zeros_like(p)
                 for p, o in zip(self.params, opened)]
        self.grads = grads  # the last step's masked gradients, by self.names
        with torch.no_grad():
            updates = self.tx.update(grads, self.opt_state, self.params)
            for g in (G_HEAD, G_TOP, G_REST):
                lr = float(lrs[g])
                sel = [i for i, lab in enumerate(self.labels) if lab == g]
                if lr != 0.0 and sel:
                    torch._foreach_add_([self.params[i] for i in sel],
                                        [updates[i] for i in sel],
                                        alpha=-lr)
            preds = logits.argmax(dim=-1)
            correct = ((preds == y).to(torch.float32) * wts).sum()
            loss_sum = (losses.detach() * wts).sum()
        for p in self.params:
            p.requires_grad_(True)
        return loss_sum, correct, n

    def train_batch(self, batch, stage: int, lrs):
        """One optimization step. Returns ``(loss_sum, correct, n)`` as
        device scalars (accumulate on the device, convert once per epoch).

        Accepts a host :class:`~sykepic_tpu_torch.train.input.HostBatch` or
        a device-resident :class:`~sykepic_tpu_torch.train.device_data.
        GatheredBatch` / ``MixedGatheredBatch``.
        """
        from .device_data import GatheredBatch, MixedGatheredBatch

        if isinstance(batch, MixedGatheredBatch):
            return self.train_batch_mixed(batch.stores, batch.idxs,
                                          batch.weights, stage, lrs)
        if isinstance(batch, GatheredBatch):
            return self.train_batch_gathered(batch.store, batch.idx,
                                             batch.weights, stage, lrs)
        store, idx = self._host_store(batch)
        return self._step([(store, idx)], self._put(batch.weights,
                                                    torch.float32),
                          stage, lrs)

    def _step(self, parts, wts, stage, lrs):
        x, y = self._preprocess(parts, train=True)
        return self._core_update(x, y, wts, stage, lrs)

    def train_batch_gathered(self, store, idx, weights, stage: int, lrs):
        """One step over rows ``idx`` of a device-resident store (see
        :class:`~sykepic_tpu_torch.train.device_data.DeviceDataset`): only
        the index vector and weights cross to the device."""
        return self._step([(store, self._put(idx, torch.int64))],
                          self._put(weights, torch.float32), stage, lrs)

    def train_batch_mixed(self, stores, idxs, weights, stage: int, lrs):
        """One step over a stratified mixed batch: ``stores`` and ``idxs``
        are parallel tuples (one store + row vector per canvas bucket), one
        K1 launch per bucket into one batch; see
        :meth:`~sykepic_tpu_torch.train.device_data.DeviceDataset.
        epoch_mixed` for why train batches mix buckets."""
        parts = [(s, self._put(i, torch.int64)) for s, i in zip(stores, idxs)]
        return self._step(parts, self._put(weights, torch.float32), stage,
                          lrs)

    def train_epoch_mixed(self, stores, idxs_stacked, weights_stacked,
                          stage: int, lrs):
        """One whole stratified epoch: ``idxs_stacked`` a tuple of
        ``(n_batches, c_i)`` row matrices, ``weights_stacked`` the
        ``(n_batches, sum c_i)`` weights
        (``DeviceDataset.epoch_mixed_stacked``). They cross to the device
        once; then a Python loop runs row ``j`` as batch ``j`` through the
        same step as :meth:`train_batch_mixed`, drawing from the generator
        in the same order, so the two train identically (the JAX package's
        whole-epoch ``lax.scan``; CUDA graphs are later work). Returns the
        summed ``(loss_sum, correct, n)`` device scalars."""
        idxs = [self._put(i, torch.int64) for i in idxs_stacked]
        wts = self._put(weights_stacked, torch.float32)
        zero = torch.zeros((), dtype=torch.float32, device=self.device)
        loss_sum, correct, n = zero, zero.clone(), zero.clone()
        for j in range(wts.shape[0]):
            ls, c, k = self._step([(s, i[j]) for s, i in zip(stores, idxs)],
                                  wts[j], stage, lrs)
            loss_sum = loss_sum + ls
            correct = correct + c
            n = n + k
        return loss_sum, correct, n

    @torch.no_grad()
    def _eval(self, parts, wts):
        self.model.eval()
        x, y = self._preprocess(parts, train=False)
        with torch.autocast(self.device.type, dtype=torch.bfloat16,
                            enabled=self.dtype == torch.bfloat16):
            logits = self.model(x.permute(0, 3, 1, 2))
        logits = logits.float()
        losses = F.cross_entropy(logits, y, reduction="none")
        preds = logits.argmax(dim=-1)
        return ((losses * wts).sum(),
                ((preds == y).to(torch.float32) * wts).sum(), wts.sum(),
                preds)

    def eval_batch_gathered(self, store, idx, weights):
        """Gathered counterpart of :meth:`eval_batch`."""
        return self._eval([(store, self._put(idx, torch.int64))],
                          self._put(weights, torch.float32))

    def eval_batch(self, batch):
        """Returns ``(loss_sum, correct, n, preds)``: device scalars and a
        device vector of predicted classes (in bucket order for a mixed
        batch, matching ``batch.labels``)."""
        from .device_data import GatheredBatch, MixedGatheredBatch

        if isinstance(batch, MixedGatheredBatch):
            # eval has no per-batch statistics, so sub-batches evaluate
            # independently
            loss_sum = correct = n = 0.0
            preds = []
            for store, idx, w in zip(batch.stores, batch.idxs,
                                     batch.split_weights()):
                ls, c, k, p = self.eval_batch_gathered(store, idx, w)
                loss_sum = loss_sum + ls
                correct = correct + c
                n = n + k
                preds.append(p)
            return loss_sum, correct, n, torch.cat(preds)
        if isinstance(batch, GatheredBatch):
            return self.eval_batch_gathered(batch.store, batch.idx,
                                            batch.weights)
        store, idx = self._host_store(batch)
        return self._eval([(store, idx)], self._put(batch.weights,
                                                     torch.float32))

    # ---------------------------------------------------------------- state
    @property
    def variables(self) -> dict:
        """The model's ``{"params", "batch_stats"}`` in the JAX package's
        layout (numpy, on the host)."""
        return checkpoint.to_flax_variables(
            self.model.state_dict(), getattr(self.model, "network", None))

    def set_variables(self, variables) -> None:
        """Load a ``{"params", "batch_stats"}`` tree into the model."""
        self.model.load_state_dict(checkpoint.from_flax_variables(
            variables, self.model.head.dropout_spec(),
            getattr(self.model, "network", None)), strict=True)

    def optimizer_state(self) -> dict:
        """The optimizer state as plain CPU tensors and ints (for
        ``train_state.pt``)."""
        return {k: v if isinstance(v, int) else [t.detach().cpu() for t in v]
                for k, v in self.opt_state.items()}

    def load_optimizer_state(self, state: dict) -> None:
        new = self.tx.init(self.params)
        if set(state) != set(new):
            raise ValueError(f"optimizer state keys {sorted(state)} do not "
                             f"match {sorted(new)}")
        for k, v in state.items():
            if isinstance(v, int):
                new[k] = int(v)
                continue
            if len(v) != len(new[k]):
                raise ValueError(f"optimizer state '{k}' has {len(v)} "
                                 f"tensors for {len(new[k])} parameters")
            for dst, src in zip(new[k], v):
                dst.copy_(src)
        self.opt_state = new


class LRSchedule:
    """Host-side LR bookkeeping: warmup stages + plateau reduction (a copy
    of ``sykepic_tpu/train/trainer.py:633-697``).

    ``lrs`` is the 3-vector the step reads; ``stage`` selects the gradient
    mask. Mirrors ``LRWarmup.__call__`` (``network.py:98-130``) and
    ``ReduceLROnPlateau`` defaults (``train.py:155-163``: mode=min, rel
    threshold 1e-4).
    """

    def __init__(self, lr: float, warmup=None, reduction=None):
        self.lrs = [lr, 0.0, 0.0]
        self.stage = 0
        self.warmup = warmup  # dict(factor_1, factor_2, step_1, step_2, step_3)
        self.reduction = reduction  # dict(factor, patience)
        self._best_loss = None
        self._bad_epochs = 0

    def start_epoch(self, epoch: int) -> None:
        w = self.warmup
        if not w:
            return
        if epoch == w["step_1"]:
            self.lrs[0] *= w["factor_1"]
        elif epoch == w["step_2"]:
            self.lrs[1] = self.lrs[0] * w["factor_1"]
            self.lrs[0] *= w["factor_2"]
            self.stage = 1
        elif epoch == w["step_3"]:
            self.lrs[2] = self.lrs[1] * w["factor_1"]
            self.lrs[0] *= w["factor_2"]
            self.stage = 2

    def end_epoch(self, epoch: int, val_loss: float) -> None:
        r = self.reduction
        if not r:
            return
        if self.warmup and epoch <= self.warmup["step_3"]:
            return  # plateau counting starts after warmup (train.py:310-312)
        if self._best_loss is None or val_loss < self._best_loss * (1 - 1e-4):
            self._best_loss = val_loss
            self._bad_epochs = 0
        else:
            self._bad_epochs += 1
            if self._bad_epochs > r["patience"]:
                self.lrs = [lr * r["factor"] for lr in self.lrs]
                self._bad_epochs = 0

    def snapshot(self) -> dict:
        """Serializable state for mid-training resume."""
        return {
            "lrs": list(self.lrs),
            "stage": self.stage,
            "best_loss": self._best_loss,
            "bad_epochs": self._bad_epochs,
        }

    def restore(self, state: dict | None) -> None:
        """Restore a :meth:`snapshot` (no-op on None)."""
        if not state:
            return
        self.lrs = [float(lr) for lr in state["lrs"]]
        self.stage = int(state["stage"])
        best = state.get("best_loss")
        self._best_loss = None if best is None else float(best)
        self._bad_epochs = int(state.get("bad_epochs", 0))
