"""Pose2Image pipeline (`mmgt_tpu/pipelines/pose2img.py`): one frame from a
reference image and a target pose, the Stage-2 image-stage validation.

The video engine at f = 1 with no audio or motion modules: the
ReferenceNet runs once per example; each DDIM step runs the denoiser once
over the CFG batch [uncond ; cond] (2b rows), with the raw banks tiled
[bk ; bk] and the first b rows gated off them (`n_uncond = b`, K1 on its
concatenated-bank route); then `scheduler.step`; the VAE decode is
clipped to [0, 1].
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Union

import torch

from mmgt_tpu_torch.device import resolve_device
from mmgt_tpu_torch.diffusion.ddim import DDIMScheduler
from mmgt_tpu_torch.models.pose_guider import PoseGuider
from mmgt_tpu_torch.models.unet3d import DenoisingUNet3D
from mmgt_tpu_torch.models.unet_ref import ReferenceUNet2D
from mmgt_tpu_torch.models.vae import AutoencoderKL
from mmgt_tpu_torch.parallel.mesh import Mesh
from mmgt_tpu_torch.pipelines.pose2vid import ModelBundle, materialize


@dataclasses.dataclass(eq=False)
class Pose2ImagePipeline(ModelBundle):
    MODEL_NAMES = ("vae", "reference_unet", "denoising_unet", "pose_guider")

    vae: AutoencoderKL
    reference_unet: ReferenceUNet2D
    denoising_unet: DenoisingUNet3D  # built with use_audio_module = use_motion_module = False
    pose_guider: PoseGuider
    scheduler: DDIMScheduler = dataclasses.field(
        default_factory=lambda: DDIMScheduler(beta_schedule="scaled_linear"))
    mesh: Optional[Mesh] = None   # the image trainer's mesh (`shard_`)

    @classmethod
    def build(cls, dtype: torch.dtype = torch.bfloat16,
              device: Optional[Union[str, torch.device]] = None, seed: int = 0,
              **kwargs) -> "Pose2ImagePipeline":
        """The full-width SD1.5 models (a denoiser without audio or motion
        modules) on `device` (the card unless the caller asks for the
        CPU), weights from `init_params(seed)`."""
        with torch.device("meta"):
            models = dict(vae=AutoencoderKL(), reference_unet=ReferenceUNet2D(),
                          denoising_unet=DenoisingUNet3D(use_audio_module=False,
                                                         use_motion_module=False),
                          pose_guider=PoseGuider())
        pipe = cls(**materialize(models, resolve_device(device), dtype), **kwargs)
        pipe.init_params(seed)
        return pipe

    @torch.no_grad()
    def __call__(self, ref_image, pose_image, clip_embed, num_inference_steps: int = 20,
                 guidance_scale: float = 3.5, generator: Optional[torch.Generator] = None,
                 latents=None) -> torch.Tensor:
        """ref_image (B, H, W, 3) in [-1, 1]; pose_image (B, H, W, 3) in
        [0, 1]; clip_embed (B, 1, 768); latents: the initial noise (B, H/8,
        W/8, 4), else drawn from `generator`. Returns (B, H, W, 3) f32 in
        [0, 1] on the pipeline's device."""
        dtype, dev = self.dtype, self.device
        ref_image, pose_image, clip_embed = (x.to(dev) for x in (ref_image, pose_image,
                                                                 clip_embed))
        b = ref_image.shape[0]
        state = self.scheduler.init(num_inference_steps)
        ref_latent = self.vae.encode_scaled(ref_image.to(dtype))
        _, banks = self.reference_unet(ref_latent, torch.zeros((b,), dtype=torch.long,
                                                               device=dev), clip_embed.to(dtype))
        banks = [torch.cat([bk, bk], 0) for bk in banks]
        pose_feat = self.pose_guider(pose_image[:, None].to(dtype))
        pose_cfg = torch.cat([pose_feat, pose_feat], 0)
        ctx_cfg = torch.cat([torch.zeros_like(clip_embed), clip_embed], 0).to(dtype)
        h8, w8 = ref_latent.shape[1], ref_latent.shape[2]
        if latents is None:
            latents = torch.randn((b, h8, w8, 4), generator=generator, dtype=torch.float32,
                                  device=dev)
        elif tuple(latents.shape) != (b, h8, w8, 4):
            raise ValueError(f"latents {tuple(latents.shape)} do not match {(b, h8, w8, 4)}")
        latents = latents.to(dev, torch.float32)
        for s in range(num_inference_steps):
            lat = torch.cat([latents, latents], 0)[:, None].to(dtype)
            t = torch.full((2 * b,), int(state.timesteps[s]), dtype=torch.long, device=dev)
            pred = self.denoising_unet(lat, t, ctx_cfg, None, pose_cfg, None, n_uncond=b,
                                       banks=banks)[:, 0].float()
            uncond, cond = pred[:b], pred[b:]
            latents = self.scheduler.step(state, uncond + guidance_scale * (cond - uncond), s,
                                          latents)
        img = self.vae.decode_scaled(latents.to(dtype))
        return (img.float() / 2 + 0.5).clamp(0.0, 1.0)
