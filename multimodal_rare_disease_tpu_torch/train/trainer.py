"""The trainer of the torch package, over all three modes (multimodal /
image_only / text_only): the counterpart of
`multimodal_rare_disease_tpu/train/trainer.py`.

- one train step: device-side augmentation (`ops/preprocess.py`), mixup,
  forward in train mode, class-weighted CE with label smoothing,
  backward and the optimizer step of `train/state.py`, with its guard
  for non-finite steps;
- bf16 compute over f32 masters: the parameters and the optimizer
  moments stay f32, the products and convolutions run in bf16 under
  `torch.autocast`; softmax, LayerNorm, the BatchNorm statistics and the
  loss stay f32;
- no kernel runs in a train step (the models' train mode, as the JAX
  layers' `not train` gates); validation runs a copy of the model in
  eval mode and in the compute dtype, where the kernels launch, on the
  eval preprocess without K4 (the JAX `use_pallas=False`);
- two data modes: the resident mode, where the corpus and the text pool
  sit on the device and each step gathers its batch by index (a Python
  loop in place of the JAX `lax.scan`), and the streaming mode, where
  host batches are copied `data.prefetch_batches` ahead. The resident
  mode is taken unless the corpus exceeds `device_corpus_budget_gb` or
  the estimated footprint exceeds 75% of the device's memory;
- the epoch loop: history, best metric, early stopping, best/last
  checkpoints, resume, and a torch.profiler trace of one epoch.

Tensor parallelism over a mesh `model` axis is not ported (ROADMAP P11).
"""

from __future__ import annotations

import logging
import os
import time
from collections import deque
from contextlib import nullcontext
from pathlib import Path
from typing import Any, Dict, Iterator, Optional

import numpy as np
import torch
import torch.nn.functional as F

from multimodal_rare_disease_tpu_torch.config import Config
from multimodal_rare_disease_tpu_torch.models.classifier import (
    create_model,
    resolve_device,
)
from multimodal_rare_disease_tpu_torch.models.layers import (
    set_dropout_generator,
)
from multimodal_rare_disease_tpu_torch.ops.preprocess import (
    eval_preprocess,
    train_preprocess,
)
from multimodal_rare_disease_tpu_torch.train.freeze import count_params
from multimodal_rare_disease_tpu_torch.train.pipeline import DataPipeline
from multimodal_rare_disease_tpu_torch.train.schedules import (
    EarlyStopping,
    make_schedule,
)
from multimodal_rare_disease_tpu_torch.train.state import TrainState
from multimodal_rare_disease_tpu_torch.utils.checkpoint import (
    load_checkpoint,
    load_train_state,
    role_path,
    save_checkpoint,
)
from multimodal_rare_disease_tpu_torch.utils.rng import RngStreams

log = logging.getLogger(__name__)

# Share of the device's memory the estimated footprint may claim before
# the resident mode gives way to streaming: the rest covers the
# allocator's workspace, fragmentation and the estimate's error.
_MEMORY_SAFETY = 0.75


def weighted_ce_loss(logits: torch.Tensor, labels: torch.Tensor,
                     class_w: torch.Tensor, label_smoothing: float,
                     valid: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The JAX trainer's loss in f32: per-sample NLL over smoothed
    targets, weighted by the label's class weight (and `valid`),
    normalized by the sum of sample weights. It is torch's
    CrossEntropyLoss(weight, label_smoothing) with either alone; with
    both, torch weights the smoothing term by each class's weight
    instead (ROADMAP F4)."""
    num_classes = logits.shape[-1]
    logp = F.log_softmax(logits.float(), dim=-1)
    onehot = F.one_hot(labels.long(), num_classes).float()
    smooth = (1.0 - label_smoothing) * onehot + label_smoothing / num_classes
    nll = -(smooth * logp).sum(-1)
    w = class_w[labels.long()]
    if valid is not None:
        w = w * valid
    return (nll * w).sum() / w.sum().clamp_min(1e-8)


def mixup_loss(logits: torch.Tensor, labels: torch.Tensor,
               perm: torch.Tensor, lam: float, class_w: torch.Tensor,
               label_smoothing: float) -> torch.Tensor:
    """λ·CE(y) + (1 − λ)·CE(y[perm]): the loss of images mixed as
    λ·x + (1 − λ)·x[perm]."""
    return (lam * weighted_ce_loss(logits, labels, class_w, label_smoothing)
            + (1.0 - lam) * weighted_ce_loss(logits, labels[perm], class_w,
                                             label_smoothing))


def device_memory_limit_bytes(device: torch.device) -> float:
    """The device's memory: the card's total (`torch.cuda.mem_get_info`),
    or the host's physical memory for the CPU."""
    if device.type == "cuda":
        return float(torch.cuda.mem_get_info(device)[1])
    return float(os.sysconf("SC_PAGE_SIZE") * os.sysconf("SC_PHYS_PAGES"))


def estimate_train_memory_bytes(cfg: Config, model: torch.nn.Module,
                                corpus_nbytes: int) -> float:
    """A conservative estimate of the resident train step's peak device
    footprint: the corpus + 4x the parameters (f32 masters, two Adam
    moments, gradients) + the buffers + activations (~32 f32 image-sized
    planes per sample for the conv pyramid, doubled for the backward; the
    BERT tower's qkv/FFN residency per layer) — the JAX estimate's
    formula."""
    param_bytes = sum(p.numel() * p.element_size()
                      for p in model.parameters())
    buf_bytes = sum(b.numel() * b.element_size() for b in model.buffers())
    b = cfg.training.batch_size
    s = cfg.data.image_size
    act = b * s * s * 3 * 4 * 32 * 2
    te = cfg.text_encoder
    act += b * cfg.data.max_text_length * te.hidden_size * 4 * (
        4 * te.num_layers)
    return float(corpus_nbytes + 4 * param_bytes + buf_bytes + act)


def _model_inputs(mode: str, batch: Dict[str, torch.Tensor], images):
    if mode == "multimodal":
        return (images, batch["input_ids"], batch["attention_mask"])
    if mode == "image_only":
        return (images,)
    return (batch["input_ids"], batch["attention_mask"])


def _to_device(a: np.ndarray, device: torch.device) -> torch.Tensor:
    """A host array on the device: integers as int64 (indices, labels,
    token ids), uint8 images and float masks as they are; pinned and
    copied without blocking on the card."""
    t = torch.from_numpy(np.ascontiguousarray(a))
    if t.dtype in (torch.int32, torch.int16, torch.int8):
        t = t.long()
    if device.type == "cuda":
        return t.pin_memory().to(device, non_blocking=True)
    return t


class Trainer:
    """Mode-switched trainer (`train_model` parity, `src/train.py:525-570`).
    Runs on `device`, the card unless the caller asks for the CPU."""

    def __init__(self, cfg: Config, mode: str = "multimodal",
                 pipeline: Optional[DataPipeline] = None,
                 workdir: Optional[str] = None, device="cuda"):
        if cfg.mesh.model_axis > 1:
            raise NotImplementedError(
                f"mesh.model_axis={cfg.mesh.model_axis}: tensor parallelism "
                f"is not ported to the torch package (ROADMAP P11)")
        self.cfg = cfg
        self.mode = mode
        self.pipeline = pipeline
        self.device = resolve_device(device)
        self.rngs = RngStreams(cfg.seed)
        self.workdir = workdir or cfg.training.checkpoint_dir
        if cfg.training.debug_nans:
            torch.autograd.set_detect_anomaly(True)
        self.compute_dtype = getattr(torch, cfg.training.compute_dtype)
        self.model = create_model(cfg, mode=mode, device=self.device,
                                  seed=cfg.seed, trainable=True)
        # augmentation and dropout draw from one generator on the device
        self.gen = torch.Generator(device=self.device).manual_seed(cfg.seed)
        set_dropout_generator(self.model, self.gen)
        self.eval_model: Optional[torch.nn.Module] = None
        self.state: Optional[TrainState] = None
        self.history: Dict[str, list] = {
            "train_loss": [], "train_acc": [], "val_loss": [], "val_acc": [],
            "lr": [],
        }
        self.best_metric_value: Optional[float] = None
        self._use_index_mode = False
        self._corpus: Optional[Dict[str, torch.Tensor]] = None
        self._use_mixup = cfg.data.mixup_alpha > 0 and mode != "text_only"

        if pipeline is not None:
            cw = np.asarray(pipeline.class_weights, np.float32)
        else:
            cw = np.ones((cfg.classifier.num_classes,), np.float32)
        if not cfg.training.use_class_weights:
            cw = np.ones_like(cw)
        self.class_weights = torch.from_numpy(cw).to(self.device)

    # -- initialization ----------------------------------------------------

    def init_state(self) -> TrainState:
        if self.state is not None:
            return self.state
        self.state = TrainState(self.cfg, self.model)
        # validation runs this copy: eval mode, the compute dtype
        self.eval_model = create_model(self.cfg, mode=self.mode,
                                       device=self.device,
                                       dtype=self.compute_dtype, seed=None)
        total, trainable = count_params(self.model)
        log.info("%s model: %.1fM params (%.1fM trainable)", self.mode,
                 total / 1e6, trainable / 1e6)

        self._use_index_mode = (self.pipeline is not None
                                and hasattr(self.pipeline, "device_corpus"))
        if self._use_index_mode:
            host = self.pipeline.device_corpus()
            nbytes = sum(np.asarray(v).nbytes for v in host.values())
            budget = float(self.cfg.training.device_corpus_budget_gb) * 1e9
            total_est = estimate_train_memory_bytes(self.cfg, self.model,
                                                    nbytes)
            limit = device_memory_limit_bytes(self.device)
            if nbytes > budget:
                log.warning(
                    "corpus is %.2f GB > device_corpus_budget_gb=%.1f; "
                    "streaming host batches instead", nbytes / 1e9,
                    self.cfg.training.device_corpus_budget_gb)
                self._use_index_mode = False
            elif total_est > _MEMORY_SAFETY * limit:
                log.warning(
                    "estimated train-step footprint %.2f GB (corpus %.2f + "
                    "params/optimizer/activations) exceeds %d%% of device "
                    "memory (%.1f GB); streaming host batches instead",
                    total_est / 1e9, nbytes / 1e9,
                    int(_MEMORY_SAFETY * 100), limit / 1e9)
                self._use_index_mode = False
            else:
                self._corpus = {k: _to_device(v, self.device)
                                for k, v in host.items()}
                log.info("device-resident corpus: %.1f MB", nbytes / 1e6)
        return self.state

    @property
    def resident(self) -> bool:
        """True when the corpus sits on the device (the index mode)."""
        return self._use_index_mode

    def _autocast(self):
        if self.compute_dtype == torch.float32:
            return nullcontext()
        return torch.autocast(self.device.type, dtype=self.compute_dtype)

    # -- steps -------------------------------------------------------------

    def train_step(self, batch: Dict[str, torch.Tensor], lr: float
                   ) -> Dict[str, Any]:
        """One step on a device batch: 'labels', uint8 'images' [B, S, S,
        3] (unless text_only), 'input_ids' / 'attention_mask' (unless
        image_only). Augments, mixes (with `data.mixup_alpha`) and steps."""
        images = None
        mix = None
        if self.mode != "text_only":
            images = train_preprocess(batch["images"], self.gen, self.cfg,
                                      self.compute_dtype)
            if self._use_mixup:
                # image mixup (ref MixupDataset): lam ~ Beta(a, a), each
                # sample paired with a permuted partner, pixels and CE mixed
                a = self.cfg.data.mixup_alpha
                rng = self.rngs.host("mixup")
                lam = float(rng.beta(a, a))
                perm = torch.from_numpy(rng.permutation(images.shape[0])).to(
                    self.device)
                images = lam * images + (1.0 - lam) * images[perm]
                mix = (lam, perm)
        return self.apply_step(images, batch, lr, mix)

    def apply_step(self, images: Optional[torch.Tensor],
                   batch: Dict[str, torch.Tensor], lr: float,
                   mix=None) -> Dict[str, Any]:
        """Forward, loss, backward and the optimizer step on model-ready
        `images` (normalized NHWC, or None for text_only); `mix` is
        mixup's (λ, permutation). → {'loss', 'acc' (device scalars),
        'skipped' (0 or 1)}."""
        state = self.init_state()
        self.model.train()
        labels = batch["labels"]
        ls = self.cfg.training.label_smoothing
        state.save_batch_stats()
        with self._autocast():
            out = self.model(*_model_inputs(self.mode, batch, images))
        logits = out["logits"].float()
        if mix is None:
            loss = weighted_ce_loss(logits, labels, self.class_weights, ls)
        else:
            loss = mixup_loss(logits, labels, mix[1], mix[0],
                              self.class_weights, ls)
        loss.backward()
        applied = state.apply_gradients(loss, lr)
        acc = (logits.detach().argmax(-1) == labels).float().mean()
        return {"loss": loss.detach(), "acc": acc,
                "skipped": int(not applied)}

    @torch.no_grad()
    def eval_step(self, batch: Dict[str, torch.Tensor]
                  ) -> Dict[str, torch.Tensor]:
        """The validation sums of one device batch ('valid' masks padded
        rows), on the eval copy of the model."""
        images = None
        if self.mode != "text_only":
            images = eval_preprocess(batch["images"], self.cfg,
                                     self.compute_dtype, use_kernel=False)
        out = self.eval_model(*_model_inputs(self.mode, batch, images))
        logits = out["logits"].float()
        labels, valid = batch["labels"], batch["valid"]
        loss = weighted_ce_loss(logits, labels, self.class_weights, 0.0,
                                valid=valid)
        correct = ((logits.argmax(-1) == labels).float() * valid).sum()
        return {"loss_sum": loss * valid.sum(), "correct": correct,
                "count": valid.sum()}

    def sync_eval_model(self) -> None:
        """Copy the trained weights and statistics into the eval copy."""
        self.init_state()
        self.eval_model.load_state_dict(self.model.state_dict())

    # -- batches -------------------------------------------------------------

    def _resident_batch(self, idx: Dict[str, np.ndarray], split: str
                        ) -> Dict[str, torch.Tensor]:
        """Gather one batch from the device-resident corpus by index."""
        c = self._corpus
        rows = _to_device(idx["rows"], self.device)
        labels = c[f"{split}_labels"][rows]
        batch = {"labels": labels}
        if "valid" in idx:
            batch["valid"] = _to_device(idx["valid"], self.device)
        if self.mode != "text_only":
            batch["images"] = c[f"{split}_images"][rows]
        if self.mode != "image_only" and "pool_ids" in c:
            zeros = torch.zeros_like(labels)
            lev = (_to_device(idx["levels"], self.device)
                   if "levels" in idx else zeros)
            var = (_to_device(idx["variants"], self.device)
                   if "variants" in idx else zeros)
            batch["input_ids"] = c["pool_ids"][labels, lev, var]
            batch["attention_mask"] = c["pool_mask"][labels, lev, var]
        return batch

    def _prefetched(self, batches: Iterator) -> Iterator:
        """Host batches copied to the device `data.prefetch_batches`
        ahead of use: the copies are issued without blocking, so the copy
        of batch N+1.. overlaps the compute of batch N on the card."""
        depth = max(1, int(self.cfg.data.prefetch_batches))
        it = iter(batches)
        buf: deque = deque()

        def place(b):
            return {k: _to_device(v, self.device) for k, v in b.items()}

        for b in it:
            buf.append(place(b))
            if len(buf) >= depth:
                break
        while buf:
            out = buf.popleft()
            nxt = next(it, None)
            if nxt is not None:
                buf.append(place(nxt))
            yield out

    # -- epoch loops -------------------------------------------------------

    def _train_epoch(self, epoch: int, schedule) -> Dict[str, float]:
        assert self.pipeline is not None
        state = self.state
        if self._use_index_mode:
            batches = (self._resident_batch(idx, "train")
                       for idx in self.pipeline.train_index_batches())
        else:
            batches = self._prefetched(self.pipeline.train_batches())
        losses, accs = [], []
        lr = 0.0
        for batch in batches:
            lr = schedule(state.step)
            m = self.train_step(batch, lr)
            losses.append(m["loss"])
            accs.append(m["acc"])
        if not losses:
            return {"loss": float("nan"), "acc": float("nan"), "lr": lr}
        return {"loss": float(torch.stack(losses).mean()),
                "acc": float(torch.stack(accs).mean()), "lr": lr}

    def _validate(self, batches: Optional[Iterator] = None
                  ) -> Dict[str, float]:
        """Loss and accuracy over the validation batches (the pipeline's,
        unless host `batches` are given)."""
        assert self.pipeline is not None or batches is not None
        self.sync_eval_model()
        if batches is None and self._use_index_mode:
            it = (self._resident_batch(idx, "val")
                  for idx in self.pipeline.val_index_batches())
        else:
            it = self._prefetched(batches if batches is not None
                                  else self.pipeline.val_batches())
        sums = None
        for batch in it:
            m = self.eval_step(batch)
            sums = m if sums is None else {k: sums[k] + m[k] for k in m}
        if sums is None or float(sums["count"]) == 0:
            return {"loss": float("nan"), "acc": float("nan")}
        n = float(sums["count"])
        return {"loss": float(sums["loss_sum"]) / n,
                "acc": float(sums["correct"]) / n}

    # -- public API --------------------------------------------------------

    def train(self, num_epochs: Optional[int] = None) -> Dict[str, Any]:
        cfg = self.cfg
        num_epochs = num_epochs or cfg.training.num_epochs
        state = self.init_state()
        spe = self.pipeline.steps_per_epoch
        schedule = make_schedule(cfg.training, spe)
        best_metric = cfg.training.best_metric
        stop_mode = "min" if best_metric == "val_loss" else "max"
        early = EarlyStopping(cfg.training.patience, cfg.training.min_delta,
                              mode=stop_mode) if cfg.training.early_stopping \
            else None

        # resume: continue after the epochs already in history
        start_epoch = len(self.history["train_loss"])
        if start_epoch and state.step == 0:
            state.step = start_epoch * spe

        t_start = time.time()
        for epoch in range(start_epoch, num_epochs):
            t0 = time.time()
            if cfg.training.profile_dir and epoch == cfg.training.profile_epoch:
                train_m = self._profiled_epoch(epoch, schedule)
            else:
                train_m = self._train_epoch(epoch, schedule)
            val_m = self._validate()
            schedule.on_validation(val_m["loss"])

            self.history["train_loss"].append(train_m["loss"])
            self.history["train_acc"].append(train_m["acc"])
            self.history["val_loss"].append(val_m["loss"])
            self.history["val_acc"].append(val_m["acc"])
            self.history["lr"].append(train_m["lr"])

            metric_value = (val_m["loss"] if best_metric == "val_loss"
                            else val_m["acc"])
            improved = (early.update(metric_value) if early is not None
                        else self._manual_best(metric_value, stop_mode))
            if improved:
                self.best_metric_value = metric_value
                if cfg.training.save_checkpoints:
                    self.save("best", epoch)
            every = max(1, cfg.training.checkpoint_every_epochs)
            is_last_epoch = (epoch + 1) == num_epochs
            if cfg.training.save_checkpoints \
                    and not cfg.training.save_best_only and (
                    (epoch + 1) % every == 0 or is_last_epoch):
                self.save("last", epoch)

            log.info(
                "epoch %3d/%d  train loss %.4f acc %.3f | val loss %.4f "
                "acc %.3f | lr %.2e | %.1fs%s",
                epoch + 1, num_epochs, train_m["loss"], train_m["acc"],
                val_m["loss"], val_m["acc"], train_m["lr"],
                time.time() - t0, "  *BEST*" if improved else "")

            if early is not None and early.should_stop:
                log.info("early stopping at epoch %d", epoch + 1)
                if cfg.training.save_checkpoints \
                        and not cfg.training.save_best_only:
                    self.save("last", epoch)
                break

        if state.skipped_steps:
            log.warning("the non-finite guard skipped %d updates",
                        state.skipped_steps)
        return {
            "history": self.history,
            "best_metric": self.best_metric_value,
            "total_time": time.time() - t_start,
            "skipped_steps": state.skipped_steps,
        }

    def _profiled_epoch(self, epoch: int, schedule) -> Dict[str, float]:
        """One train epoch under torch.profiler; the Chrome trace goes to
        `training.profile_dir`."""
        from torch.profiler import ProfilerActivity, profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            out = self._train_epoch(epoch, schedule)
        out_dir = Path(self.cfg.training.profile_dir)
        out_dir.mkdir(parents=True, exist_ok=True)
        prof.export_chrome_trace(str(out_dir / f"train_epoch{epoch}.json"))
        return out

    def _manual_best(self, value: float, mode: str) -> bool:
        if self.best_metric_value is None:
            return True
        return value < self.best_metric_value if mode == "min" \
            else value > self.best_metric_value

    def save(self, role: str, epoch: int) -> Path:
        """Write the `role` ('best' or 'last') checkpoint; 'last' also
        holds the optimizer state, the step and the skip counter."""
        state = self.init_state()
        meta = {
            "step": state.step,
            "mode": self.mode,
            "epoch": epoch,
            "best_metric": self.best_metric_value,
            "best_metric_name": self.cfg.training.best_metric,
            "history": self.history,
            "config": self.cfg.to_dict(),
        }
        class_names = getattr(self.pipeline, "class_names", None) \
            if self.pipeline else None
        if class_names:
            meta["class_names"] = list(class_names)
        tok = getattr(self.pipeline, "tokenizer", None) if self.pipeline \
            else None
        if tok is not None:
            # the vocab, so inference reproduces training tokenization
            meta["vocab"] = [t for t, _ in sorted(tok.vocab.items(),
                                                  key=lambda kv: kv[1])]
        train_state = None
        if role == "last":
            train_state = {"optimizer": state.optimizer.state_dict(),
                           "step": state.step,
                           "skipped_steps": state.skipped_steps}
        return save_checkpoint(role_path(self.workdir, self.mode, role),
                               self.model.state_dict(), meta=meta,
                               train_state=train_state)

    def load(self, path) -> None:
        """Restore the weights (and, from a 'last' checkpoint, the
        optimizer state, step and skip counter) and the history."""
        state_dict, meta = load_checkpoint(path)
        state = self.init_state()
        self.model.load_state_dict(state_dict, strict=True)
        ts = load_train_state(path)
        if ts is not None:
            state.optimizer.load_state_dict(ts["optimizer"])
            state.step = int(ts["step"])
            state.skipped_steps = int(ts["skipped_steps"])
        if meta.get("history"):
            self.history = meta["history"]


def train_model(cfg: Config, mode: str = "multimodal",
                image_dir: Optional[str] = None,
                num_epochs: Optional[int] = None,
                workdir: Optional[str] = None, device="cuda") -> Trainer:
    """End-to-end convenience entry (`train_model` parity,
    `src/train.py:525-570`): build pipeline + trainer, run, reload best."""
    pipeline = DataPipeline(cfg, mode=mode, image_dir=image_dir,
                            device=device)
    trainer = Trainer(cfg, mode=mode, pipeline=pipeline, workdir=workdir,
                      device=device)
    trainer.train(num_epochs)
    best = role_path(trainer.workdir, mode, "best")
    if best.exists():
        trainer.load(best)  # reload best (ref `src/train_multimodal.py:672-674`)
    return trainer
