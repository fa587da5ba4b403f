"""Pose2Video pipeline: the Stage-2 inference engine
(`mmgt_tpu/pipelines/pose2vid.py`) on the card.

  * `_prepare`: VAE-encode the reference image, run the ReferenceNet once
    (batch 1, cond only), project its 16 banks through the denoiser's
    attn1 to_k/to_v once (`precompute_bank_kv`), run the pose guider,
    project the audio, draw the initial noise (`pose_feat` given: the
    guider forward is skipped, as lmks2vid's summed guiders need);
  * `_denoise_chunk`: per step, the context windows are gathered by index
    and denoised `window_microbatch` at a time in one UNet call with CFG
    folded into the batch ([uncond windows ; cond windows]; the uncond half
    attends self-only and sees zero audio/CLIP context); the overlap
    average is an `index_add_` scatter; then the CFG combine and the
    solver step: the table-driven `solver_step` for DDIM(eta = 0) and
    DPM-Solver++(2M), the scheduler's own `step_carry` for stochastic or
    clipped DDIM (`solver_tables_for` gives None);
  * `_decode`: VAE decode in fixed-size frame chunks.

On a mesh (`mesh`, after `shard_(mesh)`): tensor parallelism runs inside
the models; every rank prepares and decodes alike (the same seed gives the
same latents), and each denoise group's windows split over the dp ranks
with each window's CFG pair on one rank: a rank's UNet batch is [uncond of
its windows ; cond of its windows]. A group whose window count dp does not
divide is padded with repeats of its last window, whose results are
dropped; the ranks' predictions are gathered by an `all_reduce` of a
zero-filled buffer (exact).

Frames come back as a device tensor (1, F, H, W, 3) in [0, 1] (or uint8);
`.cpu()` brings them to the host.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple, Union

import torch
from torch import nn

from mmgt_tpu_torch.device import resolve_device
from mmgt_tpu_torch.diffusion.ddim import DDIMScheduler, DDIMState
from mmgt_tpu_torch.diffusion.solver import (
    SolverTables,
    init_solver_carry,
    solver_step,
    solver_tables_for,
)
from mmgt_tpu_torch.models.audio_proj import AudioProjModel
from mmgt_tpu_torch.models.pose_guider import PoseGuider
from mmgt_tpu_torch.models.unet3d import DenoisingUNet3D, precompute_bank_kv
from mmgt_tpu_torch.models.unet_ref import ReferenceUNet2D
from mmgt_tpu_torch.models.vae import AutoencoderKL
from mmgt_tpu_torch.nn.layers import GroupNorm, LayerNorm
from mmgt_tpu_torch.ops import launch_counts
from mmgt_tpu_torch.parallel.collectives import all_reduce_
from mmgt_tpu_torch.parallel.mesh import Mesh, shard_
from mmgt_tpu_torch.pipelines.context import compute_context_schedule


def materialize(models: Dict[str, nn.Module], device: torch.device,
                dtype: torch.dtype) -> Dict[str, nn.Module]:
    """Models built on the meta device, given storage on `device` in
    `dtype` (channels_last on the card, where the convolutions run
    cuDNN's NHWC kernels); their values are left for the caller to set."""
    for m in models.values():
        m.to_empty(device=device)
        m.to(dtype)
        if device.type == "cuda":
            m.to(memory_format=torch.channels_last)
    return models


def _largest_divisor_at_most(n: int, cap: int) -> int:
    for d in range(min(cap, n), 0, -1):
        if n % d == 0:
            return d
    return 1


def window_average(pred: torch.Tensor, flat: torch.Tensor, f: int) -> torch.Tensor:
    """The overlapping windows' predictions fused into one per frame: row i
    of `pred` (n, ...) belongs to frame flat[i]; each of the f frames gets
    the mean of its rows (the JAX package's segment sum over counts)."""
    count = torch.zeros((f,), dtype=torch.float32, device=pred.device).index_add_(
        0, flat, torch.ones_like(flat, dtype=torch.float32))
    total = torch.zeros((f, *pred.shape[1:]), dtype=torch.float32, device=pred.device)
    return total.index_add_(0, flat, pred) / count.reshape(-1, *([1] * (pred.ndim - 1)))


@torch.no_grad()
def init_random_params(model: nn.Module, gen: torch.Generator, std: float = 0.02) -> nn.Module:
    """Seeded random weights for an inference model, in place: norm scales
    1, every other tensor N(0, std) drawn from `gen` (on the model's
    device); the model is put in eval mode without gradients."""
    model.eval().requires_grad_(False)
    for mod in model.modules():
        for name, p in mod.named_parameters(recurse=False):
            if isinstance(mod, (GroupNorm, LayerNorm)) and name == "weight":
                p.fill_(1.0)
            else:
                p.copy_(torch.randn(p.shape, generator=gen, device=p.device) * std)
    return model


class ModelBundle:
    """What a Stage-2 pipeline knows of its models: the dataclass fields
    named in MODEL_NAMES, their device and dtype (the denoiser's), seeded
    random weights, and the mesh they are sharded over."""

    MODEL_NAMES: Tuple[str, ...] = ()
    mesh: Optional[Mesh] = None

    def shard_(self, mesh: Optional[Mesh]):
        """Keep this rank's tensor-parallel slices of the models (in place)
        and run on `mesh` from now on. Returns the parameter specs."""
        self.mesh = mesh
        return shard_(self.models(), mesh)

    def models(self) -> Dict[str, nn.Module]:
        return {n: getattr(self, n) for n in self.MODEL_NAMES if getattr(self, n) is not None}

    @property
    def device(self) -> torch.device:
        return self.denoising_unet.conv_in.weight.device

    @property
    def dtype(self) -> torch.dtype:
        return self.denoising_unet.conv_in.weight.dtype

    @torch.no_grad()
    def init_params(self, seed: int = 0, std: float = 0.02) -> None:
        """Seeded random weights: norm scales 1, every other tensor
        N(0, std) (zero-initialised branches are not left at zero)."""
        gen = torch.Generator(device=self.device).manual_seed(seed)
        for model in self.models().values():
            init_random_params(model, gen, std)


@dataclasses.dataclass(eq=False)
class Pose2VideoPipeline(ModelBundle):
    MODEL_NAMES = ("vae", "reference_unet", "denoising_unet", "pose_guider", "audio_proj")

    vae: AutoencoderKL
    reference_unet: ReferenceUNet2D
    denoising_unet: DenoisingUNet3D
    pose_guider: PoseGuider
    audio_proj: Optional[AudioProjModel] = None
    scheduler: DDIMScheduler = dataclasses.field(default_factory=DDIMScheduler)
    context_size: int = 12
    context_overlap: int = 4
    decode_chunk_cap: int = 8
    # windows per UNet call; None = all windows at once
    window_microbatch: Optional[int] = None
    output_uint8: bool = False
    # synchronise after each phase; fill self.timings with its seconds and
    # self.phase_launches with the kernel launches it made
    profile_phases: bool = False
    # the ("dp", "tp") mesh the models are sharded over (`shard_`)
    mesh: Optional[Mesh] = None

    @classmethod
    def build(cls, dtype: torch.dtype = torch.bfloat16,
              device: Optional[Union[str, torch.device]] = None, seed: int = 0,
              **kwargs) -> "Pose2VideoPipeline":
        """The full-width SD1.5 Stage-2 models on `device` (the card unless
        the caller asks for the CPU), weights from `init_params(seed)`."""
        with torch.device("meta"):
            models = dict(vae=AutoencoderKL(), reference_unet=ReferenceUNet2D(),
                          denoising_unet=DenoisingUNet3D(), pose_guider=PoseGuider(),
                          audio_proj=AudioProjModel())
        pipe = cls(**materialize(models, resolve_device(device), dtype), **kwargs)
        pipe.init_params(seed)
        return pipe

    def _bank_shapes(self, h8: int, w8: int):
        """(tokens, channels) of the 16 banks in the order the denoiser
        consumes them."""
        chans = list(self.denoising_unet.block_out_channels)
        n = len(chans)
        layers = self.denoising_unet.layers_per_block
        shapes = []
        for bi in range(n - 1):
            shapes += [((h8 >> bi) * (w8 >> bi), chans[bi])] * layers
        shapes.append(((h8 >> (n - 1)) * (w8 >> (n - 1)), chans[-1]))
        rev = list(reversed(chans))
        for bi in range(1, n):
            shapes += [((h8 >> (n - 1 - bi)) * (w8 >> (n - 1 - bi)), rev[bi])] * (layers + 1)
        return shapes

    def _num_windows(self, f: int) -> int:
        if f <= self.context_size:
            return 1
        return -(-f // (self.context_size - self.context_overlap))

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    # ------------------------------------------------------------------
    @torch.no_grad()
    def __call__(self, ref_image, pose_video, clip_embed, masks, audio_embeds=None,
                 num_inference_steps: int = 30, guidance_scale: float = 3.5,
                 motion_scale: Sequence[float] = (1.0, 1.0, 1.0),
                 generator: Optional[torch.Generator] = None, latents=None, pose_feat=None):
        """ref_image (1, H, W, 3) in [-1, 1]; pose_video (1, F, H, W, 3) in
        [0, 1]; clip_embed (1, 1, 768); masks: 3 levels x (full, face, lip),
        each (1, F, L_level); audio_embeds (1, F, 5, 12, 768) or None;
        latents: the initial noise (F, H/8, W/8, 4), else drawn from
        `generator`; pose_feat: guider features that replace the
        PoseGuider's (`_prepare`). Returns (1, F, H, W, 3) frames on the
        pipeline's device."""
        dev = self.device
        move = lambda t: None if t is None else t.to(dev)
        masks = tuple(tuple(move(m) for m in lv) for lv in masks)
        f = pose_video.shape[1]
        tables = self.sampler_state(num_inference_steps)
        windows = torch.as_tensor(
            compute_context_schedule(num_inference_steps, f, self.context_size, 1,
                                     self.context_overlap), dtype=torch.long, device=dev)
        self.timings: Dict[str, float] = {}
        self.phase_launches: Dict[str, Dict[str, int]] = {}
        self._launches_at = launch_counts()
        t0 = time.perf_counter()
        cond, latents = self._prepare(move(ref_image), move(pose_video), move(clip_embed),
                                      masks, move(audio_embeds), generator, latents,
                                      move(pose_feat))
        t0 = self._phase("prepare", t0)
        latents, _ = self._denoise_chunk(latents, self.init_aux(tables, latents), cond, tables,
                                         windows, guidance_scale, tuple(motion_scale))
        t0 = self._phase("denoise", t0)
        frames = self._decode(latents)
        self._phase("decode", t0)
        return frames

    def sampler_state(self, num_inference_steps: int) -> Union[SolverTables, DDIMState]:
        """The generic step's tables, or the scheduler's own state where
        the generic step does not cover it (stochastic or clipped DDIM)."""
        tables = solver_tables_for(self.scheduler, num_inference_steps)
        return self.scheduler.init(num_inference_steps) if tables is None else tables

    def init_aux(self, state, latents):
        """The sampler's carry: the x0 history of the generic step, or the
        scheduler's own."""
        if isinstance(state, SolverTables):
            return init_solver_carry(latents)
        return self.scheduler.init_carry(latents)

    def _phase(self, name: str, t0: float) -> float:
        if self.profile_phases:
            self._sync()
            self.timings[f"{name}_s"] = time.perf_counter() - t0
            counts = launch_counts()
            self.phase_launches[name] = {k: n - self._launches_at[k] for k, n in counts.items()}
            self._launches_at = counts
        return time.perf_counter()

    @torch.no_grad()
    def _prepare(self, ref_image, pose_video, clip_embed, masks, audio_embeds=None,
                 generator: Optional[torch.Generator] = None, latents=None, pose_feat=None):
        """Reference branch + conditioning features + initial noise (drawn
        from `generator` unless `latents` is given). `pose_feat` (1, F, h,
        w, C0) replaces the PoseGuider's features, whose forward is then
        skipped; `pose_video` then gives only the frame count."""
        dtype, dev = self.dtype, self.device
        f = pose_video.shape[1]
        w = self._num_windows(f)
        mb = _largest_divisor_at_most(w, self.window_microbatch or w)
        ref_latent = self.vae.encode_scaled(ref_image.to(dtype))
        _, banks = self.reference_unet(
            ref_latent, torch.zeros((1,), dtype=torch.long, device=dev), clip_embed.to(dtype))
        banks_kv = precompute_bank_kv(self.denoising_unet, banks)
        if pose_feat is None:
            pose_feat = self.pose_guider(pose_video.to(dtype))
        if audio_embeds is not None:
            audio_tokens = self.audio_proj(audio_embeds.to(dtype))
        else:
            audio_tokens = torch.zeros((1, f, 32, 768), dtype=dtype, device=dev)
        ctx = clip_embed.to(dtype)
        ctx_cfg = torch.cat([torch.zeros_like(ctx).repeat(mb, 1, 1), ctx.repeat(mb, 1, 1)], 0)
        h8, w8 = ref_latent.shape[1], ref_latent.shape[2]
        if latents is None:
            latents = torch.randn((f, h8, w8, 4), generator=generator, dtype=torch.float32,
                                  device=dev)
        elif tuple(latents.shape) != (f, h8, w8, 4):
            raise ValueError(f"latents {tuple(latents.shape)} do not match {(f, h8, w8, 4)}")
        latents = latents.to(dev, torch.float32)
        cond = {
            "banks": banks,
            "banks_kv": banks_kv,
            "pose_feat": pose_feat,
            "audio_tokens": audio_tokens,
            "ctx_cfg": ctx_cfg,
            "masks": tuple(tuple(m[0].to(dtype) for m in lv) for lv in masks),
        }
        return cond, latents

    @torch.no_grad()
    def _denoise_chunk(self, latents, aux, cond, tables: Union[SolverTables, DDIMState],
                       windows, guidance_scale: float,
                       motion_scale: Tuple[float, float, float]):
        """Run windows.shape[0] steps with rows 0.. of `tables` (from
        `sampler_state`) and the carry `aux` (from `init_aux`)."""
        dtype = self.dtype
        f, h8, w8 = latents.shape[:3]
        windows = torch.as_tensor(windows, dtype=torch.long, device=latents.device)
        num_steps, w, ctx_len = windows.shape
        mb = _largest_divisor_at_most(w, self.window_microbatch or w)
        groups = w // mb
        pose_feat, audio_tokens = cond["pose_feat"], cond["audio_tokens"]
        mesh = self.mesh
        dp = 1 if mesh is None else mesh.dp
        mb_l = -(-mb // dp)   # windows a rank denoises per group
        ctx_cfg = cond["ctx_cfg"]
        if dp > 1:
            ctx_cfg = torch.cat([ctx_cfg[:1].repeat(mb_l, 1, 1),
                                 ctx_cfg[mb:mb + 1].repeat(mb_l, 1, 1)], 0)

        def denoise_windows(lat_d, step_t, idx_g):
            n = idx_g.shape[0]
            flat = idx_g.reshape(-1)
            lat_w = lat_d[flat].reshape(n, ctx_len, h8, w8, 4)
            pose_w = pose_feat[0][flat].reshape(n, ctx_len, *pose_feat.shape[2:])
            audio_w = audio_tokens[0][flat].reshape(n, ctx_len, *audio_tokens.shape[2:])
            mask_cfg = [
                tuple(torch.cat([mm[flat].reshape(n, ctx_len, -1)] * 2, 0) for mm in lv)
                for lv in cond["masks"]
            ]
            t = torch.full((2 * n,), step_t, dtype=torch.long, device=lat_d.device)
            pred = self.denoising_unet(
                torch.cat([lat_w, lat_w], 0), t, ctx_cfg,
                torch.cat([torch.zeros_like(audio_w), audio_w], 0),
                torch.cat([pose_w, pose_w], 0), mask_cfg, cond["banks_kv"],
                motion_scale, n_uncond=n,
            )
            return pred.float()

        def denoise_group(lat_d, step_t, idx_g):
            if dp == 1:
                return denoise_windows(lat_d, step_t, idx_g)
            # this rank's windows, the group padded with its last window
            idx_p = torch.cat([idx_g, idx_g[-1:].expand(mb_l * dp - mb, ctx_len)], 0)
            r = mesh.dp_rank
            mine = denoise_windows(lat_d, step_t, idx_p[r * mb_l:(r + 1) * mb_l])
            buf = mine.new_zeros((2, mb_l * dp, *mine.shape[1:]))
            buf[:, r * mb_l:(r + 1) * mb_l] = mine.reshape(2, mb_l, *mine.shape[1:])
            all_reduce_(buf, mesh.dp_group)
            return buf[:, :mb].reshape(2 * mb, *mine.shape[1:])

        for s in range(num_steps):
            idx = windows[s]
            flat = idx.reshape(-1)
            lat_d = latents.to(dtype)
            step_t = int(tables.timesteps[s])
            pred = torch.stack([denoise_group(lat_d, step_t, idx[g * mb:(g + 1) * mb])
                                for g in range(groups)])
            pred = pred.reshape(groups, 2, mb, ctx_len, h8, w8, 4)
            u = window_average(pred[:, 0].reshape(w * ctx_len, h8, w8, 4), flat, f)
            c = window_average(pred[:, 1].reshape(w * ctx_len, h8, w8, 4), flat, f)
            noise_pred = u + guidance_scale * (c - u)
            if isinstance(tables, SolverTables):
                latents, aux = solver_step(tables, noise_pred, s, latents, aux,
                                           self.scheduler.prediction_type)
            else:
                latents, aux = self.scheduler.step_carry(tables, noise_pred, s, latents, aux)
        return latents, aux

    @torch.no_grad()
    def _decode(self, latents):
        """(F, h8, w8, 4) latents -> (1, F, H, W, 3) frames, decoded in
        chunks of at most `decode_chunk_cap` frames."""
        f = latents.shape[0]
        chunk = _largest_divisor_at_most(f, self.decode_chunk_cap)
        lat = latents.to(self.dtype)
        frames = torch.cat([self.vae.decode_scaled(lat[o:o + chunk])
                            for o in range(0, f, chunk)], 0)[None]
        frames = (frames.float() / 2 + 0.5).clamp(0.0, 1.0)
        if self.output_uint8:
            return torch.round(frames * 255.0).to(torch.uint8)
        return frames
