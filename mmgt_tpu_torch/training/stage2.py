"""Stage-2 trainer (`mmgt_tpu/training/stage2.py`): the temporal/audio
fine-tune of the denoising UNet, on the card.

One `train_step`:
  1. the frozen VAE encodes the frames and the reference image;
  2. noise with a per-(example, channel) offset, a uniform t, `add_noise`
     and the v-prediction target;
  3. CFG dropout: `keep_img` zeroes the CLIP context and gates the reference
     bank off per row (`bank_gate`), `keep_aud` zeroes the audio tokens;
  4. the frozen ReferenceNet gives the banks (per example), the frozen pose
     guider its features, the trained AudioProjModel the audio tokens; the
     denoiser runs with the raw banks and `bank_gate = keep_img`;
  5. min-SNR-gamma weighted MSE;
  6. the optimizer half, `F32MasterAdamW` (shared with
     `stage2_image.Stage2ImageTrainer`): f32 gradient sums, the global-norm
     clip and AdamW on f32 master copies, and the checkpoint tree.
All randomness is drawn up front (`draws`), so a checkpointed recompute
draws nothing. The frozen branches run under `torch.no_grad()`.

Trainable set: the JAX package's, `TRAINABLE_KEYWORDS` applied to each
parameter's flax path (found through this package's copy of `map_unet3d`).
That reproduces its deviation from the reference: `mid_motion` has no
trailing underscore, so the mid block's motion module stays frozen.

`encode_clip_batch` turns a dataset's `clip_image` into the trainers'
`clip_embed`.

On a mesh (the pipeline's `mesh`, its models sharded by `shard_`), as the
JAX CLIs' jit over sharded state and batch: a step takes the GLOBAL batch,
draws its random numbers for the whole batch from the one generator, and
keeps this dp rank's rows, so dp = 2 computes what dp = 1 does on the same
batch. The accumulated gradients are averaged over dp before the clip;
the global norm sums the squares of the tp-sharded tensors over tp and
counts the replicated ones once; AdamW runs on the local shards (its
moments follow `opt_state_shardings`). `checkpoint_tree` gathers every
sharded tensor to its whole size, so a checkpoint does not depend on the
world size, and `restore` keeps this rank's slice of each.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple, Union

import torch

from mmgt_tpu_torch.diffusion.ddim import DDIMScheduler
from mmgt_tpu_torch.diffusion.losses import min_snr_weight
from mmgt_tpu_torch.parallel.collectives import all_reduce_, all_reduce_many
from mmgt_tpu_torch.parallel.mesh import (
    dp_mean,
    empty_full,
    full_tensor,
    local_slice,
    opt_state_shardings,
    param_shardings,
    shard_batch,
)
from mmgt_tpu_torch.pipelines.pose2vid import Pose2VideoPipeline
from mmgt_tpu_torch.utils.convert import map_unet2d, map_unet3d

TRAINABLE_KEYWORDS = ("_audio_", "_motion_", "audio_proj")


def _unet3d_module_names(unet) -> List[str]:
    """The flax names of DenoisingUNet3D's top-level modules."""
    n, layers = len(unet.block_out_channels), unet.layers_per_block
    names = ["conv_in", "time_embedding", "conv_norm_out", "conv_out",
             "mid_res_0", "mid_res_1", "mid_attn", "mid_motion"]
    for bi in range(n):
        names += [f"down_{bi}_{kind}_{li}" for li in range(layers)
                  for kind in ("res", "motion") + (("attn", "audio") if bi < n - 1 else ())]
        names += [f"up_{bi}_{kind}_{li}" for li in range(layers + 1)
                  for kind in ("res", "motion") + (("attn",) if bi > 0 else ())]
        if bi < n - 1:
            names += [f"down_{bi}_downsample", f"up_{bi}_upsample"]
    return names


def _unet2d_module_names(unet) -> List[str]:
    """The flax names of ReferenceUNet2D's top-level modules."""
    n, layers = len(unet.block_out_channels), len(unet.down_blocks[0].resnets)
    names = ["conv_in", "time_embedding", "conv_norm_out", "conv_out",
             "mid_res_0", "mid_res_1", "mid_attn"]
    for bi in range(n):
        names += [f"down_{bi}_{kind}_{li}" for li in range(layers)
                  for kind in ("res",) + (("attn",) if bi < n - 1 else ())]
        names += [f"up_{bi}_{kind}_{li}" for li in range(layers + 1)
                  for kind in ("res",) + (("attn",) if bi > 0 else ())]
        if bi < n - 1:
            names += [f"down_{bi}_downsample", f"up_{bi}_upsample"]
    return names


_UNET_NAMES = {"denoising_unet": (_unet3d_module_names, map_unet3d),
               "reference_unet": (_unet2d_module_names, map_unet2d)}


def _flax_path(module, model: str, key: str) -> str:
    """The flax path ("<model>/params/<module>") that the JAX package's
    partitions test for the port parameter `key` of `model` (the nn.Module
    `module`). For the two UNets the flax module is the top-level one whose
    leaves `map_unet3d` / `map_unet2d` map under the key's prefix; other
    models keep the port key."""
    if model not in _UNET_NAMES:
        return f"{model}/params/{key}"
    names, mapper = _UNET_NAMES[model]
    best = None
    for name in names(module):
        prefix = mapper(f"{name}/kernel")[: -len(".weight")]
        if key.startswith(prefix + ".") and (best is None or len(prefix) > len(best[0])):
            best = (prefix, name)
    if best is None:
        raise KeyError(f"no flax module of {model} maps to {key}")
    return f"{model}/params/{best[1]}"


def partition_by_path(models: Dict[str, torch.nn.Module], trainable_path
                      ) -> Tuple[Dict[str, torch.nn.Parameter], Dict[str, torch.nn.Parameter]]:
    """(trainable, frozen), keyed "<model>.<state-dict key>", split by
    `trainable_path(flax path)`."""
    train, frozen = {}, {}
    for model, module in models.items():
        for key, p in module.named_parameters():
            hit = trainable_path(_flax_path(module, model, key))
            (train if hit else frozen)[f"{model}.{key}"] = p
    return train, frozen


def partition_params(pipeline: Pose2VideoPipeline
                     ) -> Tuple[Dict[str, torch.nn.Parameter], Dict[str, torch.nn.Parameter]]:
    """(trainable, frozen), keyed "<model>.<state-dict key>"."""
    return partition_by_path(pipeline.models(),
                             lambda path: any(kw in path for kw in TRAINABLE_KEYWORDS))


@torch.no_grad()
def encode_clip_batch(clip_model, images: torch.Tensor) -> torch.Tensor:
    """(B, H, W, 3) images in [0, 1] -> (B, 1, 768) f32 CLIP image
    embeddings on the model's device (`mmgt_tpu/training/stage2.py:56`;
    reference train_stage_2.py:793-812). Without a CLIP model: zeros on
    the images' device, as permanent uncond-image dropout."""
    from mmgt_tpu_torch.models.clip_vision import clip_preprocess

    if clip_model is None:
        return torch.zeros((images.shape[0], 1, 768), dtype=torch.float32, device=images.device)
    w = clip_model.visual_projection.weight
    x = clip_preprocess(images.to(w.device, torch.float32))
    return clip_model(x.to(w.dtype)).float()


class AdamW:
    """optax `adamw` (b1 0.9, b2 0.999, eps 1e-8, decoupled weight decay)
    over lists of f32 tensors, in place, in the order of PyTorch's foreach
    AdamW: p *= 1 - lr wd; m = lerp(m, g, 1 - b1); v = b2 v +
    (1 - b2) g^2; p -= lr / (1 - b1^t) * m / (sqrt(v) / sqrt(1 - b2^t) +
    eps). The port keeps its own so that its state is plain tensors (`m`,
    `v`, `step_count`) that exist from the start."""

    def __init__(self, params: List[torch.Tensor], lr: float, weight_decay: float,
                 betas=(0.9, 0.999), eps: float = 1e-8):
        self.params, self.lr, self.weight_decay = list(params), lr, weight_decay
        self.betas, self.eps = tuple(betas), eps
        self.step_count = 0
        self.m = [torch.zeros_like(p) for p in self.params]
        self.v = [torch.zeros_like(p) for p in self.params]

    @torch.no_grad()
    def step(self, grads: List[torch.Tensor]) -> None:
        b1, b2 = self.betas
        self.step_count += 1
        if self.weight_decay:
            torch._foreach_mul_(self.params, 1.0 - self.lr * self.weight_decay)
        torch._foreach_lerp_(self.m, grads, 1.0 - b1)
        torch._foreach_mul_(self.v, b2)
        torch._foreach_addcmul_(self.v, grads, grads, 1.0 - b2)
        denom = torch._foreach_sqrt(self.v)
        torch._foreach_div_(denom, (1.0 - b2 ** self.step_count) ** 0.5)
        torch._foreach_add_(denom, self.eps)
        torch._foreach_addcdiv_(self.params, self.m, denom,
                                -self.lr / (1.0 - b1 ** self.step_count))


@dataclasses.dataclass(eq=False)
class TrainState:
    step: int
    trainable: Dict[str, torch.nn.Parameter]   # working weights (model dtype)
    masters: Dict[str, torch.Tensor]           # f32 copies AdamW updates
    grad_acc: Dict[str, torch.Tensor]          # f32 gradient sums
    optimizer: AdamW                           # over the masters
    micro: int = 0                             # steps accumulated so far
    frozen: Dict[str, torch.nn.Parameter] = dataclasses.field(default_factory=dict)


class F32MasterAdamW:
    """The optimizer half of a Stage-2 trainer. The subclass gives
    `learning_rate`, `weight_decay`, `max_grad_norm`,
    `gradient_accumulation_steps`, `partition()` -> (trainable, frozen),
    `loss_fn(batch, draws)` and `batch_draws(batch, generator)`.

    A step adds the trainable gradients into f32 buffers; every
    `gradient_accumulation_steps` steps their mean is clipped to a global
    norm of `max_grad_norm` (optax `clip_by_global_norm`: scaled only when
    the norm exceeds it) and AdamW (optax semantics) updates the f32 master
    copies, which are copied back into the working weights. A trainable
    tensor the loss does not reach gets a zero gradient (and so weight
    decay only), as in JAX."""

    @property
    def mesh(self):
        return self.pipeline.mesh

    def specs(self) -> Dict[str, object]:
        """{"<model>.<key>": its TPShard or None} (`param_shardings`)."""
        if self.mesh is None:
            return {}
        return param_shardings(self.mesh, self.pipeline.models())

    def init_state(self) -> TrainState:
        trainable, frozen = self.partition()
        for p in frozen.values():
            p.requires_grad_(False)
        masters = {}
        for name, p in trainable.items():
            p.requires_grad_(True)
            masters[name] = p.detach().float().clone()
        opt = AdamW(list(masters.values()), self.learning_rate, self.weight_decay)
        acc = {n: torch.zeros_like(m) for n, m in masters.items()}
        return TrainState(0, trainable, masters, acc, opt, frozen=frozen)

    def train_step(self, state: TrainState, batch: Dict,
                   draws: Optional[Dict[str, torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """One step on `state`, in place; returns the step's metrics. On a
        mesh `batch` and `draws` are the global batch's; each dp rank keeps
        its rows, and the metrics are the dp mean."""
        if draws is None:
            draws = self.batch_draws(batch, generator)
        batch, draws = shard_batch(self.mesh, batch), shard_batch(self.mesh, draws)
        names = list(state.trainable)
        loss, metrics = self.loss_fn(batch, draws)
        grads = torch.autograd.grad(loss, [state.trainable[n] for n in names], allow_unused=True)
        for n, g in zip(names, grads):
            if g is not None:
                state.grad_acc[n].add_(g.float())
        del grads
        state.micro += 1
        state.step += 1
        if state.micro == self.gradient_accumulation_steps:
            self._apply(state, names)
        return dp_mean(self.mesh, metrics)

    @torch.no_grad()
    def _apply(self, state: TrainState, names: List[str]) -> None:
        """Mean of the accumulated gradients -> global-norm clip -> AdamW on
        the f32 masters -> the working weights."""
        grads = [state.grad_acc[n] for n in names]
        mesh = self.mesh
        dp = 1 if mesh is None else mesh.dp
        if dp > 1:
            all_reduce_many(grads, mesh.dp_group)
        for g in grads:
            g.div_(self.gradient_accumulation_steps * dp)
        if mesh is None or mesh.tp == 1:
            norm = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        else:
            specs = self.specs()
            sq = [torch.linalg.vector_norm(g) ** 2 for g in grads]
            zero = grads[0].new_zeros(())
            sharded = sum((q for n, q in zip(names, sq) if specs[n] is not None), zero)
            whole = sum((q for n, q in zip(names, sq) if specs[n] is None), zero)
            norm = torch.sqrt(all_reduce_(sharded.reshape(1), mesh.tp_group)[0] + whole)
        scale = torch.where(norm < self.max_grad_norm, torch.ones_like(norm),
                            self.max_grad_norm / norm)
        torch._foreach_mul_(grads, scale)
        state.optimizer.step(grads)
        for n in names:
            state.trainable[n].copy_(state.masters[n])
            state.grad_acc[n].zero_()
        state.micro = 0

    def _local_tree(self, state: TrainState) -> Dict[str, Union[torch.Tensor, int]]:
        opt = state.optimizer
        tree: Dict[str, Union[torch.Tensor, int]] = {"step": state.step,
                                                     "adamw/step": opt.step_count}
        for i, (n, p) in enumerate(state.trainable.items()):
            tree[f"trainable/{n}"], tree[f"master/{n}"] = p.data, state.masters[n]
            tree[f"adamw/m/{n}"], tree[f"adamw/v/{n}"] = opt.m[i], opt.v[i]
        tree.update({f"frozen/{n}": p.data for n, p in state.frozen.items()})
        if self.gradient_accumulation_steps > 1:
            tree["micro"] = state.micro
            tree.update({f"grad_acc/{n}": g for n, g in state.grad_acc.items()})
        return tree

    def _entry_specs(self, state: TrainState) -> Dict[str, object]:
        """The spec of each sharded entry of `_local_tree` (an absent key is
        replicated): the per-parameter state takes its parameter's
        (`opt_state_shardings`)."""
        specs = self.specs()
        out = opt_state_shardings({n: specs[n] for n in state.trainable},
                                  ("trainable", "master", "adamw/m", "adamw/v", "grad_acc"))
        out.update({f"frozen/{n}": specs[n] for n in state.frozen})
        return out

    def checkpoint_tree(self, state: TrainState) -> Dict[str, Union[torch.Tensor, int]]:
        """Everything a resume needs, by name: the step, the working
        weights, the f32 masters, AdamW's moments and step, the frozen
        weights and, with gradient accumulation, the partial sums. On a
        mesh with tp > 1 each sharded tensor is gathered to its whole size,
        one at a time (a collective every rank takes part in): rank 0, which
        writes, keeps it on the host; the other ranks get a `meta` tensor
        of that size."""
        tree = self._local_tree(state)
        mesh = self.mesh
        if mesh is None or mesh.tp == 1:
            return tree
        for k, spec in self._entry_specs(state).items():
            if spec is not None and k in tree:
                whole = full_tensor(tree[k], spec, mesh)
                tree[k] = whole.cpu() if mesh.rank == 0 else whole.to("meta")
        return tree

    def restore(self, state: TrainState, manager, step: Optional[int] = None) -> int:
        """Load checkpoint `step` (default: the latest) of `manager` into
        `state` in place; each sharded tensor is read whole on the host and
        this rank's slice copied in. Returns the restored step."""
        local = self._local_tree(state)
        mesh = self.mesh
        specs = {} if mesh is None or mesh.tp == 1 else self._entry_specs(state)
        sharded = [k for k in local if specs.get(k) is not None]
        target = dict(local)
        for k in sharded:
            target[k] = empty_full(local[k], specs[k], mesh, device="cpu")
        got = manager.restore(target, step)
        with torch.no_grad():
            for k in sharded:
                whole = got.pop(k)
                del target[k]
                local[k].copy_(local_slice(whole, specs[k], mesh))
        state.step, state.micro = got["step"], got.get("micro", 0)
        state.optimizer.step_count = got["adamw/step"]
        return state.step


@dataclasses.dataclass(eq=False)
class Stage2Trainer(F32MasterAdamW):
    pipeline: Pose2VideoPipeline
    learning_rate: float = 1e-5
    weight_decay: float = 1e-2
    max_grad_norm: float = 1.0
    snr_gamma: float = 5.0
    noise_offset: float = 0.05
    uncond_img_ratio: float = 0.1
    uncond_audio_ratio: float = 0.05
    motion_scale: Tuple[float, float, float] = (1.0, 2.0, 3.0)
    gradient_accumulation_steps: int = 1

    def __post_init__(self):
        # training scheduler: zero-SNR v-prediction (train_stage_2.py:453-462)
        self.scheduler = DDIMScheduler()

    @classmethod
    def build(cls, dtype: torch.dtype = torch.bfloat16,
              device: Optional[Union[str, torch.device]] = None, seed: int = 0,
              remat: bool = True, **kwargs) -> "Stage2Trainer":
        """A trainer over the full-width Stage-2 models on `device` (the card
        unless the caller asks for the CPU), weights from `init_params(seed)`,
        the denoiser checkpointed when `remat`."""
        pipe = Pose2VideoPipeline.build(dtype, device=device, seed=seed)
        pipe.denoising_unet.remat = remat
        return cls(pipe, **kwargs)

    def partition(self):
        return partition_params(self.pipeline)

    def batch_draws(self, batch: Dict, generator: Optional[torch.Generator] = None):
        b, f, hh, ww = batch["pixel_values"].shape[:4]
        return self.draws(b, f, hh // 8, ww // 8, generator)

    def draws(self, b: int, f: int, h8: int, w8: int,
              generator: Optional[torch.Generator] = None) -> Dict[str, torch.Tensor]:
        """Every random number of one step: t, noise, the per-(example,
        channel) offset noise, keep_img and keep_aud."""
        dev = self.pipeline.device
        kw = dict(generator=generator, device=dev)
        return {
            "t": torch.randint(0, self.scheduler.num_train_timesteps, (b,), **kw),
            "noise": torch.randn((b, f, h8, w8, 4), **kw),
            "offset": torch.randn((b, 1, 1, 1, 4), **kw),
            "keep_img": torch.rand((b,), **kw) >= self.uncond_img_ratio,
            "keep_aud": torch.rand((b,), **kw) >= self.uncond_audio_ratio,
        }

    def loss_fn(self, batch: Dict, draws: Dict[str, torch.Tensor]):
        """(loss, {"loss", "mse"}) for one batch: pixel_values (B, F, H, W, 3)
        and ref_image (B, H, W, 3) in [-1, 1], clip_embed (B, 1, 768),
        audio_embeds (B, F, 5, 12, 768), pose_video (B, F, H, W, 3), masks
        3 levels x (full, face, lip) (B, F, L)."""
        pipe = self.pipeline
        dtype, dev = pipe.dtype, pipe.device
        pixels = batch["pixel_values"].to(dev)
        b, f = pixels.shape[:2]
        keep_img = draws["keep_img"].to(dev)
        keep_aud = draws["keep_aud"].to(dev)
        t = draws["t"].to(dev)
        with torch.no_grad():
            latents = pipe.vae.encode_scaled(pixels.reshape(b * f, *pixels.shape[2:]).to(dtype))
            h8, w8 = latents.shape[1:3]
            latents = latents.reshape(b, f, h8, w8, 4).float()
            ref_latent = pipe.vae.encode_scaled(batch["ref_image"].to(dev, dtype))
            noise = draws["noise"].to(dev)
            if self.noise_offset > 0:
                noise = noise + self.noise_offset * draws["offset"].to(dev)
            noisy = self.scheduler.add_noise(latents, noise, t)
            target = self.scheduler.get_velocity(latents, noise, t)
            clip_ctx = batch["clip_embed"].to(dev, dtype) * keep_img[:, None, None].to(dtype)
            _, banks = pipe.reference_unet(ref_latent, torch.zeros_like(t), clip_ctx)
            pose_feat = pipe.pose_guider(batch["pose_video"].to(dev, dtype))
        audio_tokens = pipe.audio_proj(batch["audio_embeds"].to(dev, dtype))
        audio_tokens = audio_tokens * keep_aud[:, None, None, None].to(dtype)
        masks = [tuple(m.to(dev, dtype) for m in lv) for lv in batch["masks"]]
        pred = pipe.denoising_unet(
            noisy.to(dtype), t, clip_ctx, audio_tokens, pose_feat, masks,
            motion_scale=self.motion_scale, banks=banks,
            bank_gate=keep_img.to(torch.int32)).float()
        per_example = ((pred - target) ** 2).mean(dim=tuple(range(1, pred.ndim)))
        w = min_snr_weight(self.scheduler.tables, t, self.snr_gamma, "v_prediction")
        loss = (w * per_example).mean()
        return loss, {"loss": loss.detach(), "mse": per_example.mean().detach()}

    def make_example_batch(self, b: int = 1, f: int = 12, height: int = 512,
                           width: int = 512) -> Dict:
        """Zero batch with the right structure (`stage2.py:221-236`)."""
        dev = self.pipeline.device
        h8, w8 = height // 8, width // 8
        z = lambda *s: torch.zeros(s, device=dev)
        return {
            "pixel_values": z(b, f, height, width, 3),
            "ref_image": z(b, height, width, 3),
            "clip_embed": z(b, 1, 768),
            "audio_embeds": z(b, f, 5, 12, 768),
            "pose_video": z(b, f, height, width, 3),
            "masks": [tuple(torch.ones((b, f, (h8 >> lv) * (w8 >> lv)), device=dev)
                            for _ in range(3)) for lv in range(3)],
        }
