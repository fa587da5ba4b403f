"""Stage-1 (SMGA) bundle (`mmgt_tpu/training/stage1.py`): the
GestureDecoder at the reference's widths (8 layers x 512, ff 1024, 8 heads;
condition 1059-d WavLM + baseline or 35-d baseline), its cosine schedule,
`sample` = DDIM(50, eta = 1) under classifier-free guidance, and training:
Adan (lr 2e-4, wd 0.02) and an EMA of the parameters (decay 0.9999,
applied after the Adan update; it starts equal to the parameters)
(SMGA.py:44-341).

The parameters are trained in place in `model`; `SMGATrainState` holds the
EMA copies and the optimizer. All randomness of a step is drawn up front
(`GestureDiffusionSchedule.training_draws`), so a test can feed JAX's.

Data parallelism (`mesh`, dp only, as `scripts/train_a2p.py:57-85`): a
step takes the global batch and its draws, keeps this rank's rows,
averages the gradients over dp, and runs the same Adan and EMA update on
every rank, so their state stays identical.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Union

import torch

from mmgt_tpu_torch.device import resolve_device
from mmgt_tpu_torch.diffusion.gesture import GestureDiffusionSchedule
from mmgt_tpu_torch.models.smga import NFEATS, GestureDecoder
from mmgt_tpu_torch.parallel.collectives import all_reduce_many
from mmgt_tpu_torch.parallel.mesh import Mesh, dp_mean, shard_batch
from mmgt_tpu_torch.training.adan import Adan

HORIZON = 80  # 3.2 s x 25 fps (SMGA.py:64-66)


def transform_if_no_negative(x: torch.Tensor) -> torch.Tensor:
    """[0, 1] -> [-1, 1] only when the tensor has no negatives
    (SMGA.py:30-42)."""
    return torch.where((x < 0).any(), x, x * 2.0 - 1.0)


@dataclasses.dataclass(eq=False)
class SMGATrainState:
    step: int
    params: Dict[str, torch.nn.Parameter]  # the model's own parameters, updated in place
    ema: Dict[str, torch.Tensor]
    opt: Adan


@dataclasses.dataclass(eq=False)
class SMGA:
    feature_type: str = "wavlm"          # "wavlm" (1024 + 35) or "baseline" (35)
    guidance_weight: float = 2.0
    horizon: int = HORIZON
    model: Optional[GestureDecoder] = None  # default: the reference's widths
    learning_rate: float = 2e-4
    weight_decay: float = 0.02
    ema_decay: float = 0.9999
    cond_drop_prob: float = 0.25
    mesh: Optional[Mesh] = None          # data parallel over its "dp" axis

    def __post_init__(self):
        if self.feature_type not in ("wavlm", "baseline"):
            raise ValueError(f"unknown feature_type {self.feature_type!r}")
        self.cond_dim = 1024 + 35 if self.feature_type == "wavlm" else 35
        if self.model is None:
            self.model = GestureDecoder(NFEATS, self.horizon, 512, 1024, 8, 8, self.cond_dim)
        self.schedule = GestureDiffusionSchedule(guidance_weight=self.guidance_weight)

    @classmethod
    def build(cls, device: Optional[Union[str, torch.device]] = None, seed: int = 0,
              model: Optional[GestureDecoder] = None, **kwargs) -> "SMGA":
        """An SMGA in f32 on `device` (the card unless the caller asks for
        the CPU) with seeded random weights (N(0, 0.02), norm scales 1);
        `model` replaces the reference-width decoder."""
        from mmgt_tpu_torch.pipelines.pose2vid import init_random_params

        dev = resolve_device(device)
        smga = cls(model=model, **kwargs)
        smga.model.to(dev, torch.float32)
        init_random_params(smga.model, torch.Generator(device=dev).manual_seed(seed))
        return smga

    @property
    def device(self) -> torch.device:
        return self.model.final_layer.weight.device

    @torch.no_grad()
    def sample(self, cond_frame: torch.Tensor, cond: torch.Tensor,
               sampling_timesteps: int = 50, generator: Optional[torch.Generator] = None,
               draws: Optional[Dict[str, torch.Tensor]] = None) -> torch.Tensor:
        """cond_frame (B, 402), cond (B, T, Dc) -> sampled poses (B, T, 402),
        on the model's device. `draws`: {"x", "noise"} as
        `GestureDiffusionSchedule.draws` makes them (default: from
        `generator`)."""
        b, t = cond.shape[0], cond.shape[1]
        dtype = self.model.final_layer.weight.dtype
        cf, c = cond_frame.to(self.device, dtype), cond.to(self.device, dtype)

        def denoise_fn(x, tb, w):
            return self.model.guided_forward(x.to(dtype), cf, c, tb, w).float()

        return self.schedule.ddim_sample(denoise_fn, (b, t, NFEATS), sampling_timesteps,
                                         generator=generator, draws=draws, device=self.device)

    # ------------------------------------------------------------- training
    def init_state(self) -> SMGATrainState:
        """Trains the model's parameters in place: the EMA starts as their
        copy, Adan's buffers as zeros."""
        params = dict(self.model.named_parameters())
        for p in params.values():
            p.requires_grad_(True)
        ema = {n: p.detach().clone() for n, p in params.items()}
        opt = Adan(list(params.values()), self.learning_rate, weight_decay=self.weight_decay)
        return SMGATrainState(0, params, ema, opt)

    def draws(self, batch_size: int, generator: Optional[torch.Generator] = None
              ) -> Dict[str, torch.Tensor]:
        return self.schedule.training_draws((batch_size, self.horizon, NFEATS),
                                            self.cond_drop_prob, generator, self.device)

    def loss_fn(self, batch: Dict[str, torch.Tensor], draws: Dict[str, torch.Tensor]):
        """(loss, components): batch {"keypoints" (B, T, 402), "cond_frame"
        (B, 402), "audio_features" (B, T, Dc)}."""
        dev = self.device
        x0 = transform_if_no_negative(batch["keypoints"].to(dev, torch.float32))
        return self.schedule.training_loss(
            self.model, x0, batch["cond_frame"].to(dev, torch.float32),
            batch["audio_features"].to(dev, torch.float32), draws)

    def train_step(self, state: SMGATrainState, batch: Dict[str, torch.Tensor],
                   draws: Optional[Dict[str, torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """One Adan step and the EMA update, in place; returns the loss and
        its six components."""
        if draws is None:
            draws = self.draws(batch["keypoints"].shape[0], generator)
        batch, draws = shard_batch(self.mesh, batch), shard_batch(self.mesh, draws)
        loss, comps = self.loss_fn(batch, draws)
        params = list(state.params.values())
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        # a parameter the step does not reach gets a zero gradient, as in JAX
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(params, grads)]
        if self.mesh is not None and self.mesh.dp > 1:
            grads = [g.contiguous() for g in grads]
            all_reduce_many(grads, self.mesh.dp_group)
            torch._foreach_div_(grads, float(self.mesh.dp))
        state.opt.step(grads)
        del grads
        with torch.no_grad():
            d = self.ema_decay
            ema = list(state.ema.values())
            torch._foreach_mul_(ema, d)  # e d + p (1 - d)
            torch._foreach_add_(ema, torch._foreach_mul(params, 1.0 - d))
        state.step += 1
        return dp_mean(self.mesh, {"loss": loss.detach(),
                                    **{k: v.detach() for k, v in comps.items()}})

    def checkpoint_tree(self, state: SMGATrainState) -> Dict[str, Union[torch.Tensor, int]]:
        """Everything a resume needs, by name: the parameters, the EMA,
        Adan's step and four buffers, and the step."""
        tree: Dict[str, Union[torch.Tensor, int]] = {"step": state.step,
                                                     "adan/step": state.opt.step_count}
        for n, p in state.params.items():
            tree[f"params/{n}"] = p.data
            tree[f"ema/{n}"] = state.ema[n]
        for k, bufs in state.opt.buffers.items():
            tree.update({f"adan/{k}/{n}": b for n, b in zip(state.params, bufs)})
        return tree

    def restore(self, state: SMGATrainState, manager, step: Optional[int] = None) -> int:
        """Load checkpoint `step` (default: the latest) of `manager` into
        `state` in place; returns the restored step."""
        got = manager.restore(self.checkpoint_tree(state), step)
        state.step, state.opt.step_count = got["step"], got["adan/step"]
        return state.step
