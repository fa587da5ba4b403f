"""The tiny nets and the seeded random Stage-2 batch that the CPU tests,
the `--tiny` options (`bench_torch.py`, `tools/budget_8chip.py`,
`scripts/verify_weights.py`, `scripts/train_stage2_image.py`) and
chip_smoke.py's small pipelines share: the one place for their widths.

  * SMALL: the small pipelines' widths (UNets of 64/128 channels with 2
    heads, a 2-layer CLIP, wav2vec2 and WavLM of width 64, a 1-layer SMGA
    decoder); its audio projection takes those encoders' (5, 2, 64)
    embeddings;
  * DRILL: the drills' widths (the JAX training CLIs' --tiny: UNets of
    16/32 channels with 4 heads; the audio projection takes full-width
    (5, 12, 768) embeddings);
  * `stage2_model(s)`: the Stage-2 nets at such widths;
  * `small_audio2vid`: the audio stack of SMALL around a Stage-2 pipeline;
  * `train_batch`: a seeded random Stage-2 batch.
"""
from __future__ import annotations

from typing import Dict, Optional, Sequence

import torch

STAGE2 = ("vae", "reference_unet", "denoising_unet", "pose_guider", "audio_proj")
SMALL = {
    "unet": dict(block_out_channels=(64, 128, 128, 128), heads=2),
    "vae": dict(block_out_channels=(32, 32, 64, 64)),
    "pose_guider": dict(embedding_channels=64, block_out_channels=(8, 16, 16, 32)),
    "audio_proj": dict(blocks=2, channels=64, intermediate_dim=64),
    "smga": dict(latent_dim=64, ff_size=128, num_layers=1, num_heads=4),
    "clip": dict(hidden_dim=64, num_layers=2, heads=4),
    "wav2vec2": dict(hidden_dim=64, num_layers=2, heads=4, ff_dim=128),
    "wavlm": dict(hidden_dim=64, num_layers=2, heads=4, ff_dim=128),
}
DRILL = {
    "unet": dict(block_out_channels=(16, 32, 32, 32), heads=4),
    "vae": dict(block_out_channels=(16, 16, 32, 32)),
    "pose_guider": dict(embedding_channels=16, block_out_channels=(4, 8, 8, 16)),
    "audio_proj": dict(intermediate_dim=32),
    "smga": dict(latent_dim=64, ff_size=64, num_layers=1, num_heads=4),
}
# the widths' key of each Stage-2 net
_WIDTHS_KEY = dict(vae="vae", reference_unet="unet", denoising_unet="unet",
                   pose_guider="pose_guider", audio_proj="audio_proj")


def stage2_model(widths: Dict[str, dict], name: str, **kw) -> torch.nn.Module:
    """The Stage-2 net `name` at `widths` (SMALL, DRILL, or {} for full
    width) and the constructor's other arguments `kw`, built wherever the
    caller's device context puts it."""
    from mmgt_tpu_torch.models.audio_proj import AudioProjModel
    from mmgt_tpu_torch.models.pose_guider import PoseGuider
    from mmgt_tpu_torch.models.unet3d import DenoisingUNet3D
    from mmgt_tpu_torch.models.unet_ref import ReferenceUNet2D
    from mmgt_tpu_torch.models.vae import AutoencoderKL

    cls = dict(vae=AutoencoderKL, reference_unet=ReferenceUNet2D,
               denoising_unet=DenoisingUNet3D, pose_guider=PoseGuider,
               audio_proj=AudioProjModel)[name]
    return cls(**widths.get(_WIDTHS_KEY[name], {}), **kw)


def stage2_models(widths: Dict[str, dict],
                  names: Optional[Sequence[str]] = None) -> Dict[str, torch.nn.Module]:
    """The Stage-2 nets named (default: all of a pipeline's) at `widths`."""
    return {n: stage2_model(widths, n) for n in names or STAGE2}


def small_audio2vid(pose2vid, config, device, dtype: torch.dtype,
                    feature_type: str = "baseline"):
    """audio2vid of SMALL's audio stack around `pose2vid`, composed as
    `Audio2VideoPipeline.build` composes the full-width one: CLIP in
    `dtype`, wav2vec2, WavLM (feature_type "wavlm") and the SMGA decoder in
    f32, all in eval mode with their default initialisation (the caller
    seeds or copies the weights)."""
    from mmgt_tpu_torch.data.audio import AudioProcessor, WavLMFeatureExtractor
    from mmgt_tpu_torch.models.clip_vision import CLIPVisionModel
    from mmgt_tpu_torch.models.smga import GestureDecoder
    from mmgt_tpu_torch.models.wav2vec2 import Wav2Vec2Model
    from mmgt_tpu_torch.models.wavlm import WavLMModel
    from mmgt_tpu_torch.pipelines.audio2vid import Audio2VideoPipeline
    from mmgt_tpu_torch.training.stage1 import SMGA

    f32 = torch.float32
    on = lambda m, dt: m.to(device, dt).eval()  # noqa: E731
    wavlm = feature_type == "wavlm"
    cond = 35 + (SMALL["wavlm"]["hidden_dim"] if wavlm else 0)
    return Audio2VideoPipeline(
        smga=SMGA(feature_type=feature_type, guidance_weight=config.a2p_guidance_weight,
                  model=on(GestureDecoder(cond_feature_dim=cond, **SMALL["smga"]), f32)),
        pose2vid=pose2vid,
        clip_model=on(CLIPVisionModel(**SMALL["clip"]), dtype),
        audio_processor=AudioProcessor(on(Wav2Vec2Model(**SMALL["wav2vec2"]), f32),
                                       fps=config.fps),
        wavlm_extractor=(WavLMFeatureExtractor(on(WavLMModel(**SMALL["wavlm"]), f32))
                         if wavlm else None),
        config=config)


def train_batch(b: int, frames: int, size: int, seed: int, device="cpu",
                audio=(5, 12, 768)) -> dict:
    """A seeded random Stage-2 batch of b clips, so that the loss is not
    trivially 0; `audio`: a frame's (windows, layers, channels) of audio
    embedding, as the audio projection takes it."""
    g = torch.Generator().manual_seed(seed)
    h8 = size // 8
    rand = lambda *s: torch.rand(*s, generator=g)  # noqa: E731
    batch = dict(
        pixel_values=rand(b, frames, size, size, 3) * 2 - 1,
        ref_image=rand(b, size, size, 3) * 2 - 1,
        clip_embed=torch.randn(b, 1, 768, generator=g),
        audio_embeds=torch.randn(b, frames, *audio, generator=g),
        pose_video=rand(b, frames, size, size, 3),
        masks=[tuple((rand(b, frames, (h8 >> lv) ** 2) > 0.4).float() for _ in range(3))
               for lv in range(3)])
    return {k: ([tuple(m.to(device) for m in lv) for lv in v] if k == "masks"
                else v.to(device)) for k, v in batch.items()}
