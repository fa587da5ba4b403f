"""Stage-2 process 1, the single-image pretrain of the spatial nets
(`mmgt_tpu/training/stage2_image.py`; reference train_stage_1.py:283-615).

The models are `Pose2ImagePipeline`'s: the denoiser without motion or audio
modules sees single frames (f = 1). Trainable: the whole denoiser, the
PoseGuider, and the ReferenceNet except its last up block
(train_stage_1.py:323-329) — the JAX package's `partition_params_image`
applied to each parameter's flax path (found through this package's
`map_unet2d` / `map_unet3d`, as the video trainer does). Loss:
scaled-linear, zero-SNR v-prediction target with min-SNR-gamma (5),
uncond_ratio 0.1, noise_offset 0.05 (config/train/stage1.yaml).

Unlike the video trainer, the ReferenceNet is trained: its per-example
banks are concatenated after the denoiser's self keys, and a dropped row
(`keep` = 0) masks its bank off through `kv_lens`, so K5's dK/dV on the bank
rows flow back into the ReferenceNet (exactly zero for dropped rows). The
optimizer half (f32 masters, clip, AdamW, checkpoint tree) is
`stage2.F32MasterAdamW`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple, Union

import torch

from mmgt_tpu_torch.diffusion.losses import min_snr_weight
from mmgt_tpu_torch.pipelines.pose2img import Pose2ImagePipeline
from mmgt_tpu_torch.training.stage2 import F32MasterAdamW, partition_by_path


def _image_trainable(path: str) -> bool:
    """`partition_params_image`'s rule on a flax path."""
    return (path.startswith("denoising_unet/") or path.startswith("pose_guider/")
            or (path.startswith("reference_unet/") and "/up_3_" not in path))


def partition_params_image(pipeline: Pose2ImagePipeline
                           ) -> Tuple[Dict[str, torch.nn.Parameter],
                                      Dict[str, torch.nn.Parameter]]:
    """(trainable, frozen), keyed "<model>.<state-dict key>"; frozen: the
    VAE and the ReferenceNet's `up_blocks.3`."""
    return partition_by_path(pipeline.models(), _image_trainable)


@dataclasses.dataclass(eq=False)
class Stage2ImageTrainer(F32MasterAdamW):
    pipeline: Pose2ImagePipeline
    learning_rate: float = 1e-5
    weight_decay: float = 1e-2
    max_grad_norm: float = 1.0
    snr_gamma: float = 5.0
    noise_offset: float = 0.05
    uncond_ratio: float = 0.1
    gradient_accumulation_steps = 1  # the JAX image trainer does not accumulate

    @classmethod
    def build(cls, dtype: torch.dtype = torch.bfloat16,
              device: Optional[Union[str, torch.device]] = None, seed: int = 0,
              **kwargs) -> "Stage2ImageTrainer":
        """A trainer over the full-width image models on `device` (the card
        unless the caller asks for the CPU), weights from
        `init_params(seed)`. No remat: the JAX trainer checkpoints nothing
        here, and at 256^2 and batch 4 the step fits the card without."""
        return cls(Pose2ImagePipeline.build(dtype, device=device, seed=seed), **kwargs)

    @property
    def scheduler(self):
        # scaled_linear + zero-SNR v-pred (config/train/stage1.yaml:33-41)
        return self.pipeline.scheduler

    def partition(self):
        return partition_params_image(self.pipeline)

    def draws(self, b: int, h8: int, w8: int, generator: Optional[torch.Generator] = None
              ) -> Dict[str, torch.Tensor]:
        """Every random number of one step: t, noise, the per-(example,
        channel) offset noise, and keep (False drops the row's CLIP context
        and reference bank)."""
        kw = dict(generator=generator, device=self.pipeline.device)
        return {
            "t": torch.randint(0, self.scheduler.num_train_timesteps, (b,), **kw),
            "noise": torch.randn((b, h8, w8, 4), **kw),
            "offset": torch.randn((b, 1, 1, 4), **kw),
            "keep": torch.rand((b,), **kw) >= self.uncond_ratio,
        }

    def batch_draws(self, batch: Dict, generator: Optional[torch.Generator] = None):
        b, hh, ww = batch["tgt_image"].shape[:3]
        return self.draws(b, hh // 8, ww // 8, generator)

    def loss_fn(self, batch: Dict, draws: Dict[str, torch.Tensor]):
        """(loss, {"loss", "mse"}) for one batch: tgt_image and ref_image
        (B, H, W, 3) in [-1, 1], tgt_pose (B, H, W, 3) in [0, 1],
        clip_embed (B, 1, 768)."""
        pipe = self.pipeline
        dtype, dev = pipe.dtype, pipe.device
        t, keep = draws["t"].to(dev), draws["keep"].to(dev)
        with torch.no_grad():  # the frozen VAE: targets only
            latents = pipe.vae.encode_scaled(batch["tgt_image"].to(dev, dtype)).float()
            ref_latent = pipe.vae.encode_scaled(batch["ref_image"].to(dev, dtype))
            noise = draws["noise"].to(dev) + self.noise_offset * draws["offset"].to(dev)
            noisy = self.scheduler.add_noise(latents, noise, t)
            target = self.scheduler.get_velocity(latents, noise, t)
        clip_ctx = batch["clip_embed"].to(dev, dtype) * keep[:, None, None].to(dtype)
        _, banks = pipe.reference_unet(ref_latent, torch.zeros_like(t), clip_ctx)
        pose_feat = pipe.pose_guider(batch["tgt_pose"][:, None].to(dev, dtype))
        pred = pipe.denoising_unet(noisy[:, None].to(dtype), t, clip_ctx, None, pose_feat, None,
                                   banks=banks, bank_gate=keep.to(torch.int32))[:, 0].float()
        per_example = ((pred - target) ** 2).mean(dim=(1, 2, 3))
        w = min_snr_weight(self.scheduler.tables, t, self.snr_gamma, "v_prediction")
        loss = (w * per_example).mean()
        return loss, {"loss": loss.detach(), "mse": per_example.mean().detach()}
